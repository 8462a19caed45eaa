"""`tanh_jet2`: the order-2 Taylor-mode rule of tanh as one CUDA kernel.

Given the pre-activation series (z, z1, z2) of a hidden Dense layer, it
returns (a, a1, a2) = (tanh z, s z1, s z2 - 2 a s z1^2), s = 1 - a^2: the
rule `jax.experimental.jet` applies to tanh inside
`neuralpde_tpu/ops/derivatives.py::jet_derivative`.  The kernel source and
its note are in `csrc/tanh_jet.cu`.

Dispatch is by the device of the tensors, never by catching an error: a CPU
tensor takes the plain PyTorch version below (`tanh_jet2_reference`,
`tanh_jet2_backward_reference`); a CUDA tensor launches the kernel or
raises.  `tanh_jet2.launches` counts kernel launches, forward and backward;
`tanh_jet2_forward_cuda.launches` and `tanh_jet2_backward_cuda.launches`
count each kernel's own.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from ._build import check, load_library

_LAUNCHER_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def tanh_jet2_reference(z, z1, z2):
    a = torch.tanh(z)
    s = 1 - a * a
    return a, s * z1, s * z2 - 2 * a * s * z1 * z1


def tanh_jet2_backward_reference(z, z1, z2, ga, ga1, ga2):
    a = torch.tanh(z)
    s = 1 - a * a
    asz1 = a * s * z1
    gz = (ga * s - 2 * asz1 * ga1
          - (2 * a * s * z2 + 2 * s * (1 - 3 * a * a) * z1 * z1) * ga2)
    return gz, s * ga1 - 4 * asz1 * ga2, s * ga2


@functools.cache
def _launchers() -> ctypes.CDLL:
    lib = load_library()
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for sfx in _LAUNCHER_SUFFIX.values():
        fwd = getattr(lib, f"tanh_jet2_forward_{sfx}")
        fwd.argtypes = [ptr] * 6 + [i64, ptr]
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"tanh_jet2_backward_{sfx}")
        bwd.argtypes = [ptr] * 9 + [i64, ptr]
        bwd.restype = ctypes.c_int
    return lib


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; other devices raise."""
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"tanh_jet2: unsupported device {t.device}")
    return t.device.type == "cuda"


def _check_operands(tensors) -> str:
    """Validate what the kernel takes; returns the launcher's dtype suffix."""
    ref = tensors[0]
    for t in tensors:
        if t.device != ref.device or t.dtype != ref.dtype or t.shape != ref.shape:
            raise ValueError(
                "tanh_jet2: operands must share device, dtype and shape; got "
                f"{[(str(x.device), x.dtype, tuple(x.shape)) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError("tanh_jet2: operands must be contiguous")
    if not ref.is_cuda:
        raise ValueError(f"tanh_jet2 kernel: tensors on {ref.device}, not CUDA")
    if ref.dtype not in _LAUNCHER_SUFFIX:
        raise ValueError(f"tanh_jet2 kernel: dtype {ref.dtype} unsupported "
                         "(float32 or float64)")
    return _LAUNCHER_SUFFIX[ref.dtype]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def tanh_jet2_forward_cuda(z, z1, z2):
    sfx = _check_operands((z, z1, z2))
    lib = _launchers()
    outs = [torch.empty_like(z) for _ in range(3)]
    with torch.cuda.device(z.device):
        code = getattr(lib, f"tanh_jet2_forward_{sfx}")(
            z.data_ptr(), z1.data_ptr(), z2.data_ptr(),
            *(o.data_ptr() for o in outs), z.numel(), _stream(z))
    check(lib, code, "tanh_jet2 forward launch")
    tanh_jet2_forward_cuda.launches += 1
    tanh_jet2.launches += 1
    return tuple(outs)


def tanh_jet2_backward_cuda(z, z1, z2, ga, ga1, ga2):
    sfx = _check_operands((z, z1, z2, ga, ga1, ga2))
    lib = _launchers()
    outs = [torch.empty_like(z) for _ in range(3)]
    with torch.cuda.device(z.device):
        code = getattr(lib, f"tanh_jet2_backward_{sfx}")(
            *(t.data_ptr() for t in (z, z1, z2, ga, ga1, ga2)),
            *(o.data_ptr() for o in outs), z.numel(), _stream(z))
    check(lib, code, "tanh_jet2 backward launch")
    tanh_jet2_backward_cuda.launches += 1
    tanh_jet2.launches += 1
    return tuple(outs)


class TanhJet2(torch.autograd.Function):
    """(z, z1, z2) -> (a, a1, a2) with the hand-written backward above.
    Training differentiates it once, so the backward is not differentiable."""

    @staticmethod
    def forward(ctx, z, z1, z2):
        ctx.save_for_backward(z, z1, z2)
        if _on_cuda(z):
            return tanh_jet2_forward_cuda(z, z1, z2)
        return tanh_jet2_reference(z, z1, z2)

    @staticmethod
    @once_differentiable
    def backward(ctx, ga, ga1, ga2):
        z, z1, z2 = ctx.saved_tensors
        if _on_cuda(z):
            return tanh_jet2_backward_cuda(
                z, z1, z2, ga.contiguous(), ga1.contiguous(), ga2.contiguous())
        return tanh_jet2_backward_reference(z, z1, z2, ga, ga1, ga2)


def tanh_jet2(z, z1, z2):
    """Order-2 Taylor rule of tanh on (H, N) tensors; see the module note."""
    return TanhJet2.apply(z, z1, z2)


# Launch counts: the two kernels' own, and their sum on the wrapper.
tanh_jet2.launches = 0
tanh_jet2_forward_cuda.launches = 0
tanh_jet2_backward_cuda.launches = 0
