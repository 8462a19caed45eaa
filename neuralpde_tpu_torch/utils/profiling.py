"""Tracing / profiling hooks (`neuralpde_tpu.utils.profiling`).

`torch.profiler` traces (a Chrome/Perfetto trace file), nested spans of
named phases (`PhaseTimer`, which `solve` fills when `enable_spans` turns
them on), anomaly detection in autograd in place of ``jax_debug_nans``, and a
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
    """Nested wall-clock spans of named phases, kept as aggregates by name.

    A span opens with `open` and closes with `close` (or both around a
    block with `phase`); a span opened while another is open is its child.
    For each name the timer keeps ``total_s`` (the spans' durations),
    ``self_s`` (each duration less the part its children cover),
    ``count``, ``max_s``, ``parent`` (the name of the span that opened the
    first of them, None at the top) and the counters given to it with
    `add`: no list of the spans themselves (a profiler's trace is the
    timeline).  While a `torch.profiler` records, each span is also a
    `torch.profiler.record_function` range of the same name, so that the
    trace shows it on the device's clock."""

    def __init__(self):
        self._stats: dict[str, dict] = {}
        # the open spans, innermost last: [name, start, children's seconds,
        # profiler range or None]
        self._open: list = []

    def open(self, name: str) -> None:
        """Open a span ``name`` inside the innermost open one."""
        if name not in self._stats:
            self._stats[name] = {
                "total_s": 0.0, "self_s": 0.0, "count": 0, "max_s": 0.0,
                "parent": self._open[-1][0] if self._open else None}
        rng = None
        if torch.autograd.profiler._is_profiler_enabled:
            rng = torch.profiler.record_function(name)
            rng.__enter__()
        self._open.append([name, time.perf_counter(), 0.0, rng])

    def close(self) -> float:
        """Close the innermost open span; returns its seconds."""
        end = time.perf_counter()
        name, start, inner, rng = self._open.pop()
        if rng is not None:
            rng.__exit__(None, None, None)
        seconds = end - start
        stats = self._stats[name]
        stats["total_s"] += seconds
        stats["self_s"] += seconds - inner
        stats["count"] += 1
        stats["max_s"] = max(stats["max_s"], seconds)
        if self._open:
            self._open[-1][2] += seconds
        return seconds

    def add(self, name: str, counter: str, n) -> None:
        """Add ``n`` to ``counter`` of the spans ``name`` (opened before)."""
        stats = self._stats[name]
        stats[counter] = stats.get(counter, 0) + n

    @contextlib.contextmanager
    def phase(self, name: str):
        """A span ``name`` around the block."""
        self.open(name)
        try:
            yield
        finally:
            self.close()

    def summary(self) -> dict:
        """``{name: {"total_s", "self_s", "count", "max_s", "parent",
        counter: n, ...}}`` of the closed spans."""
        return {k: dict(v) for k, v in self._stats.items()}


def merge_summaries(a: dict, b: dict) -> dict:
    """Two `PhaseTimer.summary` results as one: the larger ``max_s``, the
    first ``parent``, every other field summed."""
    out = {k: dict(v) for k, v in a.items()}
    for name, stats in b.items():
        if name not in out:
            out[name] = dict(stats)
            continue
        mine = out[name]
        for k, v in stats.items():
            if k == "max_s":
                mine[k] = max(mine[k], v)
            elif k != "parent":
                mine[k] = mine.get(k, 0) + v
    return out


_spans_on = False


def enable_spans(enable: bool = True) -> None:
    """Turn the program's spans on or off for the whole process (off by
    default).  With them on, each `solve` records its phases in a
    `PhaseTimer` of its own and returns its summary in
    ``result.aux["spans"]``; with them off a span site tests this switch
    and does nothing else."""
    global _spans_on
    _spans_on = bool(enable)


def spans_enabled() -> bool:
    """Whether `enable_spans` turned the spans on."""
    return _spans_on


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
