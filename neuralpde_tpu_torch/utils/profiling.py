"""Tracing / profiling hooks (`neuralpde_tpu.utils.profiling`).

`torch.profiler` traces (a Chrome/Perfetto trace file), per-phase wall
timers, anomaly detection in autograd in place of ``jax_debug_nans``, and a
residual wrapper that raises on a non-finite value in place of
``checkify``."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the enclosed block with `torch.profiler` (the host, and the
    card when there is one) and write ``<logdir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class PhaseTimer:
    """Accumulating wall-clock timers for named phases of a training run."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {k: {"total_s": round(v, 4), "count": self.counts[k]}
                for k, v in self.totals.items()}


def enable_nan_debugging(enable: bool = True) -> None:
    """Raise where a backward pass produces NaN, naming the forward op
    (`torch.autograd.set_detect_anomaly`)."""
    torch.autograd.set_detect_anomaly(enable)


def checkify_residual(fn):
    """Wrap a residual function so that it raises `FloatingPointError` on a
    non-finite output.  The check reads the result back to the host, so the
    wrapper is for debugging, not for a captured step."""

    def checked(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not bool(torch.isfinite(out).all()):
            raise FloatingPointError(
                f"non-finite residual from {getattr(fn, '__name__', fn)!r}")
        return out

    return checked
