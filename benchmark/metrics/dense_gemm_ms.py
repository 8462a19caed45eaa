"""Device time of the matrix products (the ``gemm`` class) a traced step,
in ms."""


def read(layer: dict):
    bd = layer.get("breakdown")
    if not bd or not bd["classes"]["gemm"]:
        return None
    return 1e3 * bd["classes"]["gemm"] / layer["trace_steps"]
