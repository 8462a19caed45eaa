from .core import (  # noqa: F401
    Chain, Dense, Module, TrialFunction, gelu, glorot_normal, glorot_uniform,
    identity, mlp, relu, sigmoid, sin, softplus, swish, tanh, zeros_init,
)
