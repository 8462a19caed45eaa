"""Global dtype and matmul-precision policy.

The JAX package defaults to float32 with an opt-in float64 mode
(`neuralpde_tpu.config`); here that switch is PyTorch's default dtype.
"""

from __future__ import annotations

import contextlib

import torch

# JAX `default_matmul_precision` names -> whether float32 matmuls may use
# TF32 tensor cores.  "highest" (and None, the JAX package's "inherit") is
# true float32, as on the TPU with `matmul_precision="highest"`.
_ALLOW_TF32 = {None: False, "highest": False, "high": True, "default": True}


def enable_x64(enable: bool = True) -> None:
    """Make float64 the default dtype (the reference's Float64 default)."""
    torch.set_default_dtype(torch.float64 if enable else torch.float32)


def default_float() -> torch.dtype:
    """The dtype new parameters and training sets default to."""
    return torch.get_default_dtype()


def finfo_eps(dtype) -> float:
    """Machine epsilon of ``dtype``."""
    return float(torch.finfo(dtype).eps)


@contextlib.contextmanager
def matmul_precision(precision: str | None):
    """Set `torch.backends.cuda.matmul.allow_tf32` for the body and restore
    the previous flag on exit.  Forward and backward of a training step both
    run inside it, since PyTorch reads the flag when each matmul runs."""
    if precision not in _ALLOW_TF32:
        raise ValueError(f"unknown matmul_precision {precision!r}; "
                         f"expected one of {sorted(map(str, _ALLOW_TF32))}")
    flags = torch.backends.cuda.matmul
    previous = flags.allow_tf32
    flags.allow_tf32 = _ALLOW_TF32[precision]
    try:
        yield
    finally:
        flags.allow_tf32 = previous
