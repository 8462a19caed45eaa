"""Static-shape quadrature rules (`neuralpde_tpu.ops.quadrature`;
Integrals.jl/Cubature replacement).

The reference uses h-adaptive Cubature (CubatureJLh / QuadGKJL) for both
QuadratureTraining and integro-differential terms (reference:
src/training_strategies.jl:406-436, src/discretize.jl:332-396).  Here a
training step has fixed shapes, so that it can be captured as a CUDA graph:
composite fixed-order Gauss-Legendre tensor rules, `panels**dim` sub-boxes,
each integrated with an `order`-point GL rule per axis.  Accuracy is set
statically by (order, panels).

The rules are host-side numpy, cached; `rule_tensors` keeps one copy of each
rule on each device and dtype, so that a traced or captured loss copies
nothing from the host.  `adaptive_quad_1d` and `adaptive_quad_nd` are the
runtime h-adaptive routines, on the host, for evaluation.
"""

from __future__ import annotations

import heapq
import itertools
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def gauss_legendre(order: int):
    """Nodes/weights on [-1, 1] (host-side static)."""
    x, w = np.polynomial.legendre.leggauss(order)
    return x, w


@lru_cache(maxsize=None)
def composite_gl_unit(order: int, panels: int):
    """Composite GL rule on [0, 1]: (nodes, weights), each shape (order*panels,)."""
    x, w = gauss_legendre(order)
    h = 1.0 / panels
    nodes = np.concatenate([(x + 1.0) / 2.0 * h + i * h for i in range(panels)])
    weights = np.concatenate([w / 2.0 * h for _ in range(panels)])
    return nodes, weights


def tensor_rule_unit(dim: int, order: int, panels: int = 1):
    """Tensor-product rule on the unit cube [0,1]^dim.

    Returns (nodes (dim, Q), weights (Q,)) as static numpy arrays.
    """
    n1, w1 = composite_gl_unit(order, panels)
    grids = list(itertools.product(*[range(len(n1))] * dim))
    idx = np.array(grids, dtype=np.int64).T  # (dim, Q)
    nodes = n1[idx]
    weights = np.prod(w1[idx], axis=0)
    return nodes, weights


def tensor_rule_box(lb, ub, order: int, panels: int = 1):
    """Tensor rule on the box [lb, ub] (static numpy bounds)."""
    lb = np.asarray(lb, dtype=np.float64)
    ub = np.asarray(ub, dtype=np.float64)
    nodes_u, weights_u = tensor_rule_unit(len(lb), order, panels)
    scale = ub - lb
    nodes = nodes_u * scale[:, None] + lb[:, None]
    weights = weights_u * np.prod(scale)
    return nodes, weights


_RULE_TENSORS: dict = {}


def rule_tensors(dim: int, order: int, panels: int, dtype, device):
    """`tensor_rule_unit(dim, order, panels)` as tensors ``(nodes (dim, Q),
    weights (Q,))`` on ``device``, made once per (rule, dtype, device) and
    kept: a loss that integrates reads them where they lie, so a step that
    is captured as a CUDA graph holds no copy from the host."""
    key = (dim, order, panels, dtype, torch.device(device))
    if key not in _RULE_TENSORS:
        nodes, weights = tensor_rule_unit(dim, order, panels)
        _RULE_TENSORS[key] = (
            torch.as_tensor(nodes, dtype=dtype, device=device),
            torch.as_tensor(weights, dtype=dtype, device=device))
    return _RULE_TENSORS[key]


def _host(values) -> np.ndarray:
    """Integrand values as a numpy array (tensors come back from the
    device without gradient)."""
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def integrate_box(f, lb, ub, order: int = 10, panels: int = 1, dtype=None,
                  device=None):
    """∫_[lb,ub] f(x) dx with f: (dim, Q) -> (out, Q). Static bounds."""
    nodes, weights = tensor_rule_box(lb, ub, order, panels)
    x = torch.as_tensor(nodes, dtype=dtype, device=device)
    w = torch.as_tensor(weights, dtype=dtype, device=device)
    return torch.sum(f(x) * w[None, :], dim=-1)


def adaptive_quad_1d(f, a: float, b: float, *, reltol: float = 1e-6,
                     abstol: float = 1e-3, maxiters: int = 1000,
                     order_low: int = 7, order_high: int = 15):
    """h-adaptive 1-D quadrature with an embedded Gauss pair error estimate.

    The runtime-adaptivity escape hatch promised for parity with the
    reference's QuadGKJL/CubatureJLh path (reference:
    src/training_strategies.jl:406-436, src/discretize.jl:359-360): intervals
    are bisected greedily (worst error first) until the global error estimate
    |I_high − I_low| meets ``max(abstol, reltol·|I|)`` or ``maxiters``
    subinterval evaluations are spent.  Runs on the host — use for
    evaluation/debugging (`get_numeric_integral(..., adaptive=True)`), not
    inside a training loss (that is what the static auto-refined rules are
    for).

    ``f(nodes)`` maps a (Q,) node vector to (..., Q) integrand values.
    Returns (integral (...,), error_estimate: float).
    """
    xl, wl = gauss_legendre(order_low)
    xh, wh = gauss_legendre(order_high)

    def panel(a0, b0):
        mid, half = 0.5 * (a0 + b0), 0.5 * (b0 - a0)
        fh = _host(f(mid + half * xh))
        fl = _host(f(mid + half * xl))
        i_h = (fh * wh).sum(-1) * half
        i_l = (fl * wl).sum(-1) * half
        return i_h, float(np.max(np.abs(i_h - i_l)))

    total_i, total_err = panel(a, b)
    heap = [(-total_err, 0, a, b, total_i, total_err)]
    counter, evals = 1, 1
    while evals < maxiters:
        tol = max(abstol, reltol * float(np.max(np.abs(total_i))))
        if total_err <= tol:
            break
        _, _, a0, b0, i0, e0 = heapq.heappop(heap)
        m = 0.5 * (a0 + b0)
        i1, e1 = panel(a0, m)
        i2, e2 = panel(m, b0)
        total_i = total_i - i0 + i1 + i2
        total_err = total_err - e0 + e1 + e2
        heapq.heappush(heap, (-e1, counter, a0, m, i1, e1))
        heapq.heappush(heap, (-e2, counter + 1, m, b0, i2, e2))
        counter += 2
        evals += 2
    return total_i, total_err


def adaptive_quad_nd(f, lb, ub, *, reltol: float = 1e-6, abstol: float = 1e-3,
                     maxiters: int = 1000, order_low: int = 4,
                     order_high: int = 7):
    """h-adaptive n-D cubature over the box [lb, ub] (the n-D analog of
    `adaptive_quad_1d`, covering the reference's CubatureJLh evaluation path
    for multi-variable integrals, reference: src/discretize.jl:332-396).

    Each box is integrated with an embedded tensor Gauss-Legendre pair
    (order_high vs order_low) giving the local error estimate; the
    worst-error box is bisected along its LONGEST edge (the h-adaptive
    CubatureJLh strategy) until the global estimate meets
    ``max(abstol, reltol·|I|)`` or ``maxiters`` box evaluations are spent.
    Host-side — for evaluation/debugging, not training losses.

    ``f(nodes)`` maps a (dim, Q) node matrix to (..., Q) integrand values.
    Returns (integral (...,), error_estimate: float).
    """
    lb = np.asarray(lb, dtype=np.float64)
    ub = np.asarray(ub, dtype=np.float64)
    dim = lb.shape[0]
    nh, wh = tensor_rule_unit(dim, order_high)
    nl, wl = tensor_rule_unit(dim, order_low)

    def box(a, b):
        scale = b - a
        vol = float(np.prod(scale))
        fh = _host(f(a[:, None] + scale[:, None] * nh))
        fl = _host(f(a[:, None] + scale[:, None] * nl))
        i_h = (fh * wh).sum(-1) * vol
        i_l = (fl * wl).sum(-1) * vol
        return i_h, float(np.max(np.abs(i_h - i_l)))

    total_i, total_err = box(lb, ub)
    heap = [(-total_err, 0, lb, ub, total_i, total_err)]
    counter, evals = 1, 1
    while evals < maxiters:
        tol = max(abstol, reltol * float(np.max(np.abs(total_i))))
        if total_err <= tol:
            break
        _, _, a0, b0, i0, e0 = heapq.heappop(heap)
        axis = int(np.argmax(b0 - a0))
        m = 0.5 * (a0[axis] + b0[axis])
        b1 = b0.copy(); b1[axis] = m
        a2 = a0.copy(); a2[axis] = m
        i1, e1 = box(a0, b1)
        i2, e2 = box(a2, b0)
        total_i = total_i - i0 + i1 + i2
        total_err = total_err - e0 + e1 + e2
        heapq.heappush(heap, (-e1, counter, a0, b1, i1, e1))
        heapq.heappush(heap, (-e2, counter + 1, a2, b0, i2, e2))
        counter += 2
        evals += 2
    return total_i, total_err


def integrate_parametric_1d(f, lb: torch.Tensor, ub: torch.Tensor,
                            order: int = 10, panels: int = 1):
    """Batched 1-D integrals with per-column bounds.

    ``lb``/``ub`` have shape (N,); ``f(nodes)`` maps (N, Q) node matrix ->
    (out, N, Q) integrand values.  Returns (out, N).  Used for
    integro-differential terms with parametric limits (reference:
    src/discretize.jl:332-396 evaluates these per-column in a host loop;
    here it is one batched computation).
    """
    nu, wu = rule_tensors(1, order, panels, lb.dtype, lb.device)
    scale = (ub - lb)  # (N,)
    nodes = lb[:, None] + scale[:, None] * nu[0][None, :]  # (N, Q)
    vals = f(nodes)  # (out, N, Q)
    return torch.sum(vals * wu[None, None, :], dim=-1) * scale[None, :]
