"""``tanh_jet2``'s share of its roofline, in percent: the bytes its traced
calls must move (each input read once and each output written once, at
the one shape the program launched each kernel at) over the card's
published bandwidth, over the calls' device time.  Forward and backward
together; nothing when a kernel ran at several shapes or not at all."""

import math

from reference import flops

KINDS = ("forward", "backward")


def read(layer: dict):
    bd = layer.get("breakdown")
    shapes = layer.get("launch_shapes", {})
    if not bd:
        return None
    moved, seconds = 0, 0.0
    for kind in KINDS:
        launched = set(shapes.get(f"tanh_jet2_{kind}", ()))
        runs = [(s, n) for name, (s, n) in bd["kernels"].items()
                if f"tanh_jet2_{kind}" in name]
        if not runs:
            continue
        if len(launched) != 1:
            return None
        numel = math.prod(next(iter(launched)))
        calls = sum(n for _, n in runs)
        moved += calls * flops.tanh_jet2_bytes(numel, 4, kind)
        seconds += sum(s for s, _ in runs)
    if not seconds:
        return None
    return 100 * moved / flops.PEAK_BYTES_PER_S / seconds
