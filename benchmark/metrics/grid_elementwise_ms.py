"""Device time of the elementwise kernels a traced step, in ms: on the
separable grid route, the sums and products of grid tensors that form the
residuals, their squares and their backward."""


def read(layer: dict):
    bd = layer.get("breakdown")
    if not bd or not bd["classes"]["elementwise"]:
        return None
    return 1e3 * bd["classes"]["elementwise"] / layer["trace_steps"]
