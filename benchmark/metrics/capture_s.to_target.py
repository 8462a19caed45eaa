"""Seconds ``solve`` spent capturing CUDA graphs a trial in the window
(its counter summed over the finished trials' solves, over their number):
each 500-step solve captures its own graphs."""


def read(layer: dict):
    return layer.get("capture_per_trial_s")
