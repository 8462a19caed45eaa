"""The whole step's share of the card's published float32 peak: the step's
model FLOPs counted from the shapes (`reference.flops`) over the window's
step time (all its work over all its time), in percent."""

from reference import flops


def read(layer: dict):
    if not layer.get("step_s"):
        return None
    return 100 * layer["model_flops"] / layer["step_s"] / flops.PEAK_FLOPS[
        "float32"]
