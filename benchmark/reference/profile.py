"""Device time by kernel class from a `torch.profiler` trace.

A frozen copy of `classify` and `breakdown` of
`scripts/torch_profile_breakdown.py`, so that the benchmark's reading of a
trace does not move when the program's scripts do.  Busy time is the union
of the device events' intervals; the idle share is one less the busy time
over the traced window, both read in the same window.
"""

from __future__ import annotations

import collections

CLASSES = ("gemm", "hand_written", "elementwise", "reduce", "copy/layout",
           "rng", "nccl", "other")
# lower-case name fragments of each class, tried in this order: a class
# earlier in the list wins (a cuBLAS split-K reduction and a GEMV are
# matrix products, a Philox draw runs in an elementwise kernel, a copy or
# an index copy too)
_MARKS = (("nccl", ("nccl",)),
          ("hand_written", ("tanh_jet2", "zoom_step", "set_conditional")),
          ("gemm", ("gemm", "xmma", "sm90_", "cutlass", "splitkreduce",
                    "gemv")),
          ("rng", ("philox", "distribution_elementwise")),
          ("copy/layout", ("memcpy", "memset", "copy", "catarray", "index",
                           "gather", "scatter", "transpose")),
          ("reduce", ("reduce", "cub::")),
          ("elementwise", ("elementwise", "foreach", "multi_tensor_apply")))
TOP = 10            # device operations and idle gaps kept in the breakdown


def classify(name: str) -> str:
    """The class (`CLASSES`) of a device event from its kernel name."""
    low = name.lower()
    for cls, marks in _MARKS:
        if any(m in low for m in marks):
            return cls
    return "other"


def _union(intervals):
    """Merge (start, end) intervals: the merged list, sorted."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def split_events(events):
    """(device events, host events) of a profiler's ``events()``; a range
    that annotates device work is left out, or its kernels would count
    twice."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append(e)
        elif e.device_type == DeviceType.CPU:
            host.append(e)
    return device, host


def breakdown(device, host, window_s: float) -> dict:
    """What the device did in a traced window of ``window_s`` seconds.

    ``device`` and ``host``: events with ``name`` and ``time_range`` (us),
    as `split_events` returns them.  Returns ``{"busy_s", "window_s",
    "idle_share", "classes": {class: s}, "kernels": {name: [s, calls]},
    "device_ops": [[name, s]] (the `TOP` longest in all),
    "idle_gaps": [[host operation open at its start, s]] (the `TOP`
    longest)}``: totals over the window, not per step."""
    classes = dict.fromkeys(CLASSES, 0.0)
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        s = (e.time_range.end - e.time_range.start) / 1e6
        classes[classify(e.name)] += s
        kernels[e.name][0] += s
        kernels[e.name][1] += 1
    busy = _union((e.time_range.start, e.time_range.end) for e in device)
    busy_s = sum(end - start for start, end in busy) / 1e6

    def open_at(t):
        ops = [e for e in host if e.time_range.start <= t < e.time_range.end]
        return (max(ops, key=lambda e: e.time_range.start).name if ops
                else "none")

    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:TOP]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "idle_share": 1.0 - busy_s / window_s,
        "classes": classes,
        "kernels": {k: list(v) for k, v in kernels.items()},
        "device_ops": [[name, s] for name, (s, _) in top],
        "idle_gaps": [[open_at(t), us / 1e6] for us, t in gaps],
    }
