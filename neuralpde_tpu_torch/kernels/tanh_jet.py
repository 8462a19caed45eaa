"""`tanh_jet2`: the order-2 Taylor-mode rule of tanh as CUDA kernels.

Given the pre-activation series (z, z1, z2) of a hidden Dense layer, it
returns (a, a1, a2) = (tanh z, s z1, s z2 - 2 a s z1^2), s = 1 - a^2: the
rule `jax.experimental.jet` applies to tanh inside
`neuralpde_tpu/ops/derivatives.py::jet_derivative`.  The kernel sources and
their note are in `csrc/tanh_jet.cu`.

The rule is an `autograd.Function` in the `setup_context` form, so it
composes with `torch.func` (`jvp`, `vjp`, `vmap`, `grad`) as the JAX
package's jet composes with `jax.jvp`/`jax.vjp`/`jax.vmap`:

* `TanhJet2` runs the forward kernel; its backward is `TanhJet2Backward`
  (the backward kernel, J^T g) and its forward-mode rule is `TanhJet2Jvp`
  (the jvp kernel, J t), where J is the per-element 3x3 Jacobian of the rule;
* the derivatives of those two (second order in the rule, third order in
  tanh) are plain PyTorch ops, a static choice: no path on the card runs
  them hot, and plain ops differentiate to any order;
* each Function has an explicit `vmap` rule: the op is elementwise, so the
  batch dimension moves to the front and the kernel runs on the whole block.

Dispatch is by the device of the tensors, never by catching an error: a CPU
tensor takes the plain PyTorch versions below (`tanh_jet2_reference`,
`tanh_jet2_backward_reference`, `tanh_jet2_jvp_reference`); a CUDA tensor
launches the kernel or raises.  `tanh_jet2.launches` counts kernel launches
of all three kernels; `tanh_jet2_forward_cuda.launches`,
`tanh_jet2_backward_cuda.launches` and `tanh_jet2_jvp_cuda.launches` count
each kernel's own; `LAUNCH_SHAPES` holds every (kernel, shape) launched.
A replay of a captured CUDA graph launches the kernels its capture counted
without passing through the wrappers: a graph runner reports each replay
with `add_replayed`, and `replayed_counts` holds those launches apart.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check, load_library

_LAUNCHER_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# every (kernel name, operand shape) launched since the import, or since a
# caller cleared it: how a run shows at which shapes it used the kernels
LAUNCH_SHAPES: set[tuple[str, tuple[int, ...]]] = set()


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle).  The three
# first-order ones evaluate in the kernels' order, so float32 agrees bitwise.
# ---------------------------------------------------------------------------

def tanh_jet2_reference(z, z1, z2):
    a = torch.tanh(z)
    s = 1 - a * a
    return a, s * z1, s * z2 - 2 * a * s * z1 * z1


def tanh_jet2_backward_reference(z, z1, z2, ga, ga1, ga2):
    """J^T (ga, ga1, ga2): the rule's vector-Jacobian product."""
    a = torch.tanh(z)
    s = 1 - a * a
    asz1 = a * s * z1
    gz = (ga * s - 2 * asz1 * ga1
          - (2 * a * s * z2 + 2 * s * (1 - 3 * a * a) * z1 * z1) * ga2)
    return gz, s * ga1 - 4 * asz1 * ga2, s * ga2


def tanh_jet2_jvp_reference(z, z1, z2, tz, tz1, tz2):
    """J (tz, tz1, tz2): the rule's Jacobian-vector product."""
    a = torch.tanh(z)
    s = 1 - a * a
    asz1 = a * s * z1
    c = -(2 * a * s * z2 + 2 * s * (1 - 3 * a * a) * z1 * z1)
    return (s * tz, s * tz1 - 2 * asz1 * tz,
            c * tz - 4 * asz1 * tz1 + s * tz2)


def _curvatures(z):
    """a = tanh z and the z-derivatives the rule's second derivatives need:
    s = 1 - a^2 = a', p = a s (s' = -2p), q = s (1 - 3a^2) = p',
    dq = q' = -4 a s (2 - 3a^2)."""
    a = torch.tanh(z)
    s = 1 - a * a
    p = a * s
    return s, p, s * (1 - 3 * a * a), -4 * p * (2 - 3 * a * a)


def _second_directional(z, z1, z2, t, u):
    """D^2 F[t, u]: the rule's second derivative along the tangent triples
    t and u (symmetric in them)."""
    _, p, q, dq = _curvatures(z)
    t0, t1, t2 = t
    u0, u1, u2 = u
    tu0 = t0 * u0
    return (-2 * p * tu0,
            -2 * q * z1 * tu0 - 2 * p * (t0 * u1 + u0 * t1),
            ((-2 * q * z2 - 2 * dq * z1 * z1) * tu0
             - 2 * p * (t0 * u2 + u0 * t2) - 4 * q * z1 * (t0 * u1 + t1 * u0)
             - 4 * p * t1 * u1))


def _second_adjoint(z, z1, z2, g, h):
    """grad over (z, z1, z2) of g . (J h): D^2 F contracted with the
    cotangent triple g on the outputs and the tangent triple h."""
    _, p, q, dq = _curvatures(z)
    g0, g1, g2 = g
    h0, h1, h2 = h
    return (-2 * p * (g0 * h0 + g2 * h2) + g1 * (-2 * q * z1 * h0 - 2 * p * h1)
            + g2 * ((-2 * q * z2 - 2 * dq * z1 * z1) * h0 - 4 * q * z1 * h1),
            -2 * p * g1 * h0 + g2 * (-4 * q * z1 * h0 - 4 * p * h1),
            -2 * p * g2 * h0)


# ---------------------------------------------------------------------------
# Kernel launchers
# ---------------------------------------------------------------------------

@functools.cache
def _launchers() -> ctypes.CDLL:
    lib = load_library()
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    for sfx in _LAUNCHER_SUFFIX.values():
        fwd = getattr(lib, f"tanh_jet2_forward_{sfx}")
        fwd.argtypes = [ptr] * 6 + [i64, ptr]
        fwd.restype = ctypes.c_int
        for kind in ("backward", "jvp"):
            fn = getattr(lib, f"tanh_jet2_{kind}_{sfx}")
            fn.argtypes = [ptr] * 9 + [i64, ptr]
            fn.restype = ctypes.c_int
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


def _launch(kind: str, operands) -> tuple:
    sfx = _check_operands(operands)
    lib = _launchers()
    ref = operands[0]
    outs = [torch.empty_like(ref) for _ in range(3)]
    with torch.cuda.device(ref.device):
        code = getattr(lib, f"tanh_jet2_{kind}_{sfx}")(
            *(t.data_ptr() for t in operands), *(o.data_ptr() for o in outs),
            ref.numel(), torch.cuda.current_stream(ref.device).cuda_stream)
    check(lib, code, f"tanh_jet2 {kind} launch")
    tanh_jet2.launches += 1
    LAUNCH_SHAPES.add((f"tanh_jet2_{kind}", tuple(ref.shape)))
    return tuple(outs)


def tanh_jet2_forward_cuda(z, z1, z2):
    out = _launch("forward", (z, z1, z2))
    tanh_jet2_forward_cuda.launches += 1
    return out


def tanh_jet2_backward_cuda(z, z1, z2, ga, ga1, ga2):
    out = _launch("backward", (z, z1, z2, ga, ga1, ga2))
    tanh_jet2_backward_cuda.launches += 1
    return out


def tanh_jet2_jvp_cuda(z, z1, z2, tz, tz1, tz2):
    out = _launch("jvp", (z, z1, z2, tz, tz1, tz2))
    tanh_jet2_jvp_cuda.launches += 1
    return out


# ---------------------------------------------------------------------------
# autograd.Functions
# ---------------------------------------------------------------------------

def _run(kernel, plain, operands):
    """The kernel on CUDA tensors (made contiguous), the plain version on
    CPU tensors."""
    if _on_cuda(operands[0]):
        return kernel(*(t.contiguous() for t in operands))
    return plain(*operands)


def _filled(tangents, like):
    return [torch.zeros_like(like) if t is None else t for t in tangents]


def _elementwise_vmap(fn, info, in_dims, args):
    """vmap rule of an elementwise Function: batch dimensions to the front
    (unbatched operands expanded), one call on the whole block."""
    args = [(x.movedim(d, 0) if d is not None
             else x.expand(info.batch_size, *x.shape)).contiguous()
            for x, d in zip(args, in_dims)]
    out = fn.apply(*args)
    return out, (0,) * len(out)


class TanhJet2(torch.autograd.Function):
    """(z, z1, z2) -> (a, a1, a2)."""

    @staticmethod
    def forward(z, z1, z2):
        return _run(tanh_jet2_forward_cuda, tanh_jet2_reference, (z, z1, z2))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, ga, ga1, ga2):
        z, z1, z2 = ctx.saved_tensors
        return TanhJet2Backward.apply(z, z1, z2, *_filled((ga, ga1, ga2), z))

    @staticmethod
    def jvp(ctx, tz, tz1, tz2):
        z, z1, z2 = ctx.saved_tensors
        return TanhJet2Jvp.apply(z, z1, z2, *_filled((tz, tz1, tz2), z))

    @staticmethod
    def vmap(info, in_dims, z, z1, z2):
        return _elementwise_vmap(TanhJet2, info, in_dims, (z, z1, z2))


class TanhJet2Backward(torch.autograd.Function):
    """(z, z1, z2, g) -> J^T g, the backward kernel.  Its own derivatives
    (in z and in g) are plain PyTorch ops."""

    @staticmethod
    def forward(z, z1, z2, ga, ga1, ga2):
        return _run(tanh_jet2_backward_cuda, tanh_jet2_backward_reference,
                    (z, z1, z2, ga, ga1, ga2))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, hz, hz1, hz2):
        z, z1, z2, *g = ctx.saved_tensors
        h = _filled((hz, hz1, hz2), z)
        # d/dz of h . J^T g = g . J h, and d/dg of it is J h
        return (*_second_adjoint(z, z1, z2, g, h),
                *tanh_jet2_jvp_reference(z, z1, z2, *h))

    @staticmethod
    def jvp(ctx, dz, dz1, dz2, dga, dga1, dga2):
        z, z1, z2, *g = ctx.saved_tensors
        d = _filled((dz, dz1, dz2), z)
        lin = tanh_jet2_backward_reference(z, z1, z2,
                                           *_filled((dga, dga1, dga2), z))
        curv = _second_adjoint(z, z1, z2, g, d)
        return tuple(x + y for x, y in zip(lin, curv))

    @staticmethod
    def vmap(info, in_dims, *args):
        return _elementwise_vmap(TanhJet2Backward, info, in_dims, args)


class TanhJet2Jvp(torch.autograd.Function):
    """(z, z1, z2, t) -> J t, the jvp kernel.  Its own derivatives (in z and
    in t) are plain PyTorch ops."""

    @staticmethod
    def forward(z, z1, z2, tz, tz1, tz2):
        return _run(tanh_jet2_jvp_cuda, tanh_jet2_jvp_reference,
                    (z, z1, z2, tz, tz1, tz2))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, ga, ga1, ga2):
        z, z1, z2, *t = ctx.saved_tensors
        g = _filled((ga, ga1, ga2), z)
        return (*_second_adjoint(z, z1, z2, g, t),
                *tanh_jet2_backward_reference(z, z1, z2, *g))

    @staticmethod
    def jvp(ctx, dz, dz1, dz2, dtz, dtz1, dtz2):
        z, z1, z2, *t = ctx.saved_tensors
        lin = tanh_jet2_jvp_reference(z, z1, z2,
                                      *_filled((dtz, dtz1, dtz2), z))
        curv = _second_directional(z, z1, z2, t, _filled((dz, dz1, dz2), z))
        return tuple(x + y for x, y in zip(lin, curv))

    @staticmethod
    def vmap(info, in_dims, *args):
        return _elementwise_vmap(TanhJet2Jvp, info, in_dims, args)


def tanh_jet2(z, z1, z2):
    """Order-2 Taylor rule of tanh on (H, N) tensors; see the module note."""
    return TanhJet2.apply(z, z1, z2)


KERNELS = {"tanh_jet2_forward": tanh_jet2_forward_cuda,
           "tanh_jet2_backward": tanh_jet2_backward_cuda,
           "tanh_jet2_jvp": tanh_jet2_jvp_cuda}


# each kernel's launches made by replays of captured CUDA graphs
_REPLAYED: dict[str, int] = {}


def reset_launch_counts() -> None:
    """Set every launch count to 0 (not the replayed ones)."""
    tanh_jet2.launches = 0
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    """Each kernel's launches through its wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def add_replayed(captured: dict, replays: int = 1) -> None:
    """Count ``replays`` replays of a graph whose capture launched
    ``captured`` (a `launch_counts` difference)."""
    for name, n in captured.items():
        _REPLAYED[name] += n * replays


def reset_replayed_counts() -> None:
    """Set every replayed count to 0."""
    for name in KERNELS:
        _REPLAYED[name] = 0


def replayed_counts() -> dict:
    """Each kernel's launches made by graph replays since the last reset."""
    return dict(_REPLAYED)


def counts_since(before: dict) -> dict:
    """Each kernel's wrapper launches since ``before`` (a `launch_counts`)."""
    return {name: n - before[name] for name, n in launch_counts().items()}


reset_launch_counts()
reset_replayed_counts()
