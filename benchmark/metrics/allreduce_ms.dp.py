"""Device time of the NCCL kernels a traced step on rank 0, in ms."""


def read(layer: dict):
    bd = layer.get("breakdown")
    if not bd or not bd["classes"]["nccl"]:
        return None
    return 1e3 * bd["classes"]["nccl"] / layer["trace_steps"]
