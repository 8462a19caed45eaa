"""`sq_sum`: the sum of squares of a tensor, in float64, as a CUDA kernel.

The factored mean-square route of the separable contraction
(`compile.separable.factored_msq`) writes a residual grid once and takes its
mean square with this kernel: one read of the grid, squares summed in
float64, no atomics (the kernel sources and their note are in
`csrc/sq_sum.cu`).  The result is a 0-d float64 tensor on the input's
device; it carries no gradient (the caller's backward is its own).

Dispatch is by the device of the tensor, never by catching an error: a CPU
tensor takes the plain PyTorch version `sq_sum_reference`; a CUDA tensor
launches the kernel or raises.  `sq_sum_cuda.launches` counts the wrapper's
launches and `LAUNCH_SHAPES` holds every (kernel, shape) launched.  A replay
of a captured CUDA graph launches the kernel without passing through the
wrapper, so a captured step counts once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check, load_library

_LAUNCHER_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# resident 256-thread blocks an SM takes: the grid is at most this many a SM
BLOCKS_PER_SM = 8
# every (kernel name, operand shape) launched since the import, or since a
# caller cleared it
LAUNCH_SHAPES: set[tuple[str, tuple[int, ...]]] = set()


def sq_sum_reference(r: torch.Tensor) -> torch.Tensor:
    """Σ r², summed in float64: the plain version (the CPU path and the
    kernel's oracle)."""
    return torch.sum(r.double() ** 2)


@functools.cache
def _launchers() -> ctypes.CDLL:
    lib = load_library()
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for sfx in _LAUNCHER_SUFFIX.values():
        fn = getattr(lib, f"sq_sum_{sfx}")
        fn.argtypes = [ptr, i64, ptr, i64, ptr, ptr]
        fn.restype = ctypes.c_int
    lib.sq_sum_block_items.argtypes = [ctypes.c_int]
    lib.sq_sum_block_items.restype = i64
    return lib


@functools.cache
def _max_blocks(device_index: int) -> int:
    props = torch.cuda.get_device_properties(device_index)
    return props.multi_processor_count * BLOCKS_PER_SM


def sq_sum_cuda(r: torch.Tensor) -> torch.Tensor:
    """Σ r² of a contiguous float32 or float64 CUDA tensor by the kernel."""
    if not r.is_cuda:
        raise ValueError(f"sq_sum kernel: tensor on {r.device}, not CUDA")
    if r.dtype not in _LAUNCHER_SUFFIX:
        raise ValueError(f"sq_sum kernel: dtype {r.dtype} unsupported "
                         "(float32 or float64)")
    if not r.is_contiguous():
        raise ValueError("sq_sum kernel: the tensor must be contiguous")
    lib = _launchers()
    n = r.numel()
    items = lib.sq_sum_block_items(r.element_size())
    blocks = max(1, min(_max_blocks(r.device.index), -(-n // items)))
    partials = torch.empty(blocks, dtype=torch.float64, device=r.device)
    out = torch.empty((), dtype=torch.float64, device=r.device)
    with torch.cuda.device(r.device):
        code = getattr(lib, f"sq_sum_{_LAUNCHER_SUFFIX[r.dtype]}")(
            r.data_ptr(), n, partials.data_ptr(), blocks, out.data_ptr(),
            torch.cuda.current_stream(r.device).cuda_stream)
    check(lib, code, "sq_sum launch")
    sq_sum_cuda.launches += 1
    LAUNCH_SHAPES.add(("sq_sum", tuple(r.shape)))
    return out


sq_sum_cuda.launches = 0


def sq_sum(r: torch.Tensor) -> torch.Tensor:
    """Σ r² in float64 (a 0-d tensor on ``r``'s device); see the module
    note."""
    if r.device.type == "cuda":
        return sq_sum_cuda(r)
    if r.device.type == "cpu":
        return sq_sum_reference(r)
    raise ValueError(f"sq_sum: unsupported device {r.device}")
