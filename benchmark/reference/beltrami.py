"""Plain PyTorch reference of the (3+1)-D Navier-Stokes Beltrami SPINN and
its Adam steps.

The configuration's problem, the (3+1)-D Navier-Stokes experiment of the
separable PINN paper (Cho et al., arXiv 2306.15969): the Ethier-Steinman
(1994) Beltrami flow with ``a = d = 1`` and ``nu = 1`` on ``[-1, 1]^3 x
[0, 1]``,

    u_t + u u_x + v u_y + w u_z + p_x = nu (u_xx + u_yy + u_zz)   (v, w alike)
    u_x + v_y + w_z = 0,

with the analytic velocities at ``t = 0`` (three initial conditions, weight
100), on the six faces of the cube (18 Dirichlet conditions, weight 10) and
the analytic pressure at the origin over ``t`` (the gauge, weight 10).  Each
field is a rank-``r`` separable product ``sum_r X_r(x) Y_r(y) Z_r(z)
T_r(t)`` of four tanh MLPs from one coordinate to ``r`` features (weights
``(out, in)``, biases ``(out, 1)``), on the static grid of the nodes ``lo +
k (hi - lo) / (n - 1)`` of each axis as the program's dtype holds them.

Each momentum and the continuity residual is weighted causally in ``t``:
with ``L_i`` its mean square over ``(x, y, z)`` at the i-th time node, the
loss is ``mean_i(w_i L_i)`` with ``w_i = exp(-eps dt sum_{j<i} L_j)``,
``dt`` the node spacing, the weights detached.  A condition's loss is the
mean square of its residual over its own grid (three axes; the gauge's one).
The total is the four PDE losses plus the weighted conditions.

The axis features' derivatives are taken by nested forward-mode products
(`torch.func.jvp`), independent of the Taylor-mode arithmetic under test.
Every grid tensor is formed by an explicit contraction over the rank, as
one matrix product of the row products of two axes' features and of the
other two's.  The interior grid is taken in slabs of ``SLAB_T`` time nodes:
a first pass without gradients gives the ``L_i`` and so the weights, a
second gives each slab's weighted loss and its gradient with respect to the
feature matrices; the conditions are taken whole; the gradients are then
carried back through the axis nets.  TF32 is off unless asked for (the
control).  The file imports only torch and numpy.

Departures from the published description: the widths, rank, grid, the
conditions' weights and the causal weighting (eps 1, the first stage) are
the port's recipe (``examples/beltrami_spinn.py``), since the paper's
appendix could not be checked here; the grid is static, where the paper
draws the axis points anew; the causal weighting in ``t`` is that of
Wang, Sankaran and Perdikaris (2022), on the grid's time nodes.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jvp

FIELDS = "uvwp"
SPANS = ((-1.0, 1.0), (-1.0, 1.0), (-1.0, 1.0), (0.0, 1.0))
A = D = NU = 1.0
WEIGHTS = {"initial": 100.0, "face": 10.0, "gauge": 10.0}
# derivative order each field takes on each axis (x, y, z, t)
ORDERS = {"u": (2, 2, 2, 1), "v": (2, 2, 2, 1), "w": (2, 2, 2, 1),
          "p": (1, 1, 1, 0)}
SLAB_T = 13         # time nodes a slab of the interior grid


def axis_nodes(n: int, span, node_dtype, dtype, device) -> torch.Tensor:
    """The ``n`` static nodes of an axis over ``span``, rounded to
    ``node_dtype`` (the program's), in ``dtype``."""
    lo, hi = span
    h = (hi - lo) / (n - 1)
    return torch.tensor(lo + h * np.arange(n), dtype=node_dtype).to(
        dtype=dtype, device=device)


def axis_net(params: dict, prefix: str, z: torch.Tensor) -> torch.Tensor:
    """The axis net ``prefix`` at nodes ``z`` ``(n, 1)`` -> ``(n, rank)``."""
    layers = sum(k.startswith(prefix) and k.endswith(".weight")
                 for k in params)
    h = z
    for i in range(layers):
        h = (h @ params[f"{prefix}layer_{i}.weight"].T
             + params[f"{prefix}layer_{i}.bias"].T)
        if i < layers - 1:
            h = torch.tanh(h)
    return h


def features(params: dict, prefix: str, z: torch.Tensor, order: int) -> list:
    """``[F, F', ..., F^(order)]`` of one axis net at nodes ``z`` ``(n,
    1)``, each ``(n, rank)``, by nested `torch.func.jvp`."""
    ones = torch.ones_like(z)
    fns = [lambda t: axis_net(params, prefix, t)]
    for _ in range(order):
        fns.append(lambda t, prev=fns[-1]: jvp(prev, (t,), (ones,))[1])
    return [f(z) for f in fns]


def grid(*factors) -> torch.Tensor:
    """``sum_r prod_a F_a[i_a, r]`` of ``(N_a, r)`` factor matrices, as one
    matrix product of the first half's row products and the second's."""
    def rows(fs):
        out = fs[0]
        for f in fs[1:]:
            out = (out[:, None, :] * f[None, :, :]).reshape(-1, f.shape[1])
        return out

    if len(factors) == 1:
        return factors[0].sum(1)
    half = (len(factors) + 1) // 2
    return (rows(factors[:half]) @ rows(factors[half:]).T).reshape(
        [f.shape[0] for f in factors])


def analytic(x, y, z, t):
    """The analytic ``(u, v, w, p)`` at tensors that broadcast together."""
    e, s, c = torch.exp, torch.sin, torch.cos
    dec = e(-(D ** 2) * t)
    u = -A * (e(A * x) * s(A * y + D * z) + e(A * z) * c(A * x + D * y)) * dec
    v = -A * (e(A * y) * s(A * z + D * x) + e(A * x) * c(A * y + D * z)) * dec
    w = -A * (e(A * z) * s(A * x + D * y) + e(A * y) * c(A * z + D * x)) * dec
    p = (-(A ** 2) / 2.0) * (
        e(2 * A * x) + e(2 * A * y) + e(2 * A * z)
        + 2 * s(A * x + D * y) * c(A * z + D * x) * e(A * (y + z))
        + 2 * s(A * y + D * z) * c(A * x + D * y) * e(A * (z + x))
        + 2 * s(A * z + D * x) * c(A * y + D * z) * e(A * (x + y))
    ) * e(-2 * (D ** 2) * t)
    return {"u": u, "v": v, "w": w, "p": p}


def _interior(F: dict, ts: slice) -> list:
    """The four PDE residuals on the t-slab ``ts`` of the interior grid
    from the feature matrices ``F[field][axis][order]``: the 27 grid
    tensors the equations need, each formed once."""
    g = {}
    for f in FIELDS:
        X, Y, Z, T = F[f]
        Tt = [c[ts] for c in T]
        if f != "p":
            g[f] = grid(X[0], Y[0], Z[0], Tt[0])
            g[f + "t"] = grid(X[0], Y[0], Z[0], Tt[1])
            for k in (1, 2):
                g[f + "x" * k] = grid(X[k], Y[0], Z[0], Tt[0])
                g[f + "y" * k] = grid(X[0], Y[k], Z[0], Tt[0])
                g[f + "z" * k] = grid(X[0], Y[0], Z[k], Tt[0])
        else:
            g["px"] = grid(X[1], Y[0], Z[0], Tt[0])
            g["py"] = grid(X[0], Y[1], Z[0], Tt[0])
            g["pz"] = grid(X[0], Y[0], Z[1], Tt[0])
    out = []
    for f, a in zip("uvw", "xyz"):
        lap = g[f + "xx"] + g[f + "yy"] + g[f + "zz"]
        out.append(g[f + "t"] + g["u"] * g[f + "x"] + g["v"] * g[f + "y"]
                   + g["w"] * g[f + "z"] + g["p" + a] - NU * lap)
    out.append(g["ux"] + g["vy"] + g["wz"])
    return out


def _slab_means(F: dict, ts: slice) -> list:
    """Each PDE residual's mean square over ``(x, y, z)`` at the slab's
    time nodes: four ``(len(ts),)`` tensors."""
    return [(r * r).mean(dim=(0, 1, 2)) for r in _interior(F, ts)]


def _conditions(params: dict, F: dict, nodes: list, weights: dict, dtype,
                device):
    """The weighted sum of the 22 conditions' mean squares: the initial
    conditions, the faces (x = -1, 1, y = -1, 1, z = -1, 1; u, v, w each)
    and the gauge, ``weights`` as `WEIGHTS`.  A constant slot's features
    come from its axis net at that point."""
    def at(f, axis, value):
        z = torch.full((1, 1), value, dtype=dtype, device=device)
        return axis_net(params, f"{f}.axis_{axis}.", z)[0]

    def coords(fixed: dict):
        """Each coordinate at a fixed value or its nodes, shaped to
        broadcast over the free axes in order."""
        free = [a for a in range(4) if a not in fixed]
        out = []
        for a in range(4):
            if a in fixed:
                out.append(torch.tensor(fixed[a], dtype=dtype, device=device))
            else:
                shape = [1] * len(free)
                shape[free.index(a)] = -1
                out.append(nodes[a].reshape(shape))
        return free, out

    def msq(f, fixed):
        free, xyzt = coords(fixed)
        c = math.prod(at(f, a, v) for a, v in fixed.items())
        mats = [F[f][a][0] for a in free]
        mats[-1] = mats[-1] * c
        r = grid(*mats) - analytic(*xyzt)[f]
        return (r * r).mean()

    total = sum(weights["initial"] * msq(f, {3: 0.0}) for f in "uvw")
    for axis in range(3):
        for value in (-1.0, 1.0):
            total = total + sum(weights["face"] * msq(f, {axis: value})
                                for f in "uvw")
    return total + weights["gauge"] * msq("p", {0: 0.0, 1: 0.0, 2: 0.0})


def loss_and_grads(params: dict, counts, eps: float, dtype, node_dtype,
                   keep: int = 1, weights=WEIGHTS) -> tuple:
    """(loss, {leaf: gradient}) at ``params`` on the grid of ``counts``
    nodes on the axes x, y, z, t, the conditions weighted by ``weights``.
    ``keep`` > 1 plants a fault for the control readings: the interior
    losses keep the first 1/keep of the time nodes, the mean taken over
    them."""
    for p in params.values():
        p.grad = None
    device = next(iter(params.values())).device
    nodes = [axis_nodes(n, s, node_dtype, dtype, device)
             for n, s in zip(counts, SPANS)]
    feats = {f: [features(params, f"{f}.axis_{a}.", nodes[a][:, None],
                          ORDERS[f][a]) for a in range(4)]
             for f in FIELDS}
    F = {f: [[c.detach().requires_grad_(True) for c in axis]
             for axis in feats[f]] for f in FIELDS}
    n_t = counts[3]
    kept = n_t // keep
    slabs = [slice(s, min(s + SLAB_T, kept)) for s in range(0, kept, SLAB_T)]
    with torch.no_grad():
        L = [torch.cat(parts) for parts in
             zip(*(_slab_means(F, ts) for ts in slabs))]
    dt = (SPANS[3][1] - SPANS[3][0]) / (n_t - 1)
    w = [torch.exp(-eps * (torch.cumsum(l, 0) - l) * dt) for l in L]
    loss = sum(float((wi * li).mean()) for wi, li in zip(w, L))
    for ts in slabs:
        part = sum((wi[ts] * li).sum() for wi, li in
                   zip(w, _slab_means(F, ts))) / kept
        part.backward()
    bcs = _conditions(params, F, nodes, weights, dtype, device)
    bcs.backward()
    loss += float(bcs.detach())
    pairs = [(out, leaf) for f in FIELDS
             for outs, leaves in zip(feats[f], F[f])
             for out, leaf in zip(outs, leaves) if leaf.grad is not None]
    torch.autograd.backward([out for out, _ in pairs],
                            [leaf.grad for _, leaf in pairs])
    return loss, {k: p.grad.detach().clone() for k, p in params.items()}


class Adam:
    """optax.adam's rule (b1 0.9, b2 0.999, eps 1e-8) in the parameters'
    dtype, as `reference.dense.Adam` has it (repeated here so that this
    file imports only torch and numpy)."""

    def __init__(self, params: dict, lr: float):
        self.lr = lr
        self.t = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        b1, b2, eps = 0.9, 0.999, 1e-8
        self.t += 1
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.nu[k].sqrt() / math.sqrt(1 - b2 ** self.t) + eps
            p.sub_(self.lr / (1 - b1 ** self.t) * self.mu[k] / denom)


def follow(init: dict, counts, eps: float, lr: float, steps: int, dtype,
           node_dtype=torch.float32, keep: int = 1, tf32: bool = False,
           weights=WEIGHTS) -> dict:
    """``steps`` Adam steps from ``init`` with TF32 matrix products off
    (on with ``tf32``, the control); the keys of `reference.dense.follow`:
    ``{"losses", "grad": {leaf: first gradient's norm}, "change": {leaf:
    norm of the change after the steps}}``."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        params = {k: v.detach().to(dtype).clone().requires_grad_(True)
                  for k, v in init.items()}
        opt = Adam(params, lr)
        losses, first = [], None
        for _ in range(steps):
            loss, grads = loss_and_grads(params, counts, eps, dtype,
                                         node_dtype, keep, weights)
            losses.append(loss)
            if first is None:
                first = {k: float(g.double().norm())
                         for k, g in grads.items()}
            opt.step(params, grads)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    change = {k: float((params[k].detach().double() - init[k].double())
                       .norm()) for k in init}
    return {"losses": losses, "grad": first, "change": change}
