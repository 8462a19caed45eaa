"""Device time of the matrix products (the ``gemm`` class) a traced step,
in ms: on the separable grid route, the rank contractions that write the
grid tensors and their backward products."""


def read(layer: dict):
    bd = layer.get("breakdown")
    if not bd or not bd["classes"]["gemm"]:
        return None
    return 1e3 * bd["classes"]["gemm"] / layer["trace_steps"]
