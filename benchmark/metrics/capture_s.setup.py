"""Seconds ``solve`` spent capturing CUDA graphs during set-up, from its
own counter (``result.aux["cuda_graph"]["capture_seconds"]``)."""


def read(layer: dict):
    return layer.get("capture_setup_s")
