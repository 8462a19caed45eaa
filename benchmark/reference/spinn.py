"""Plain PyTorch reference of the separable (SPINN) 2-D Poisson problem and
its Adam steps.

The configuration's problem: ``u_xx + u_yy = -sin(pi x) sin(pi y)`` on the
unit square with no boundary terms; the trial function is ``u(x, y) =
sum_r F_r(x) G_r(y)`` with ``F = x (1 - x) N_x(x)`` and ``G = y (1 - y)
N_y(y)``, each ``N`` a tanh MLP from one coordinate to ``rank`` features.
The loss is the mean square of the residual over the ``n x n`` grid of the
static nodes ``k / (n - 1)``, ``k = 0 .. n - 1``, on both axes.

The axis features' derivatives are taken by nested forward-mode products
(`torch.func.jvp`), independent of the Taylor-mode arithmetic under test;
the grid residual is formed in blocks of rows, its gradient with respect
to the four feature matrices summed over the blocks and then carried back
through the axis nets.  It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jvp

from .dense import Adam

BLOCK_ROWS = 1024


def nodes(n: int, device) -> torch.Tensor:
    """The static grid nodes of one axis, float32."""
    return torch.tensor(np.arange(n) * (1.0 / (n - 1)), dtype=torch.float32,
                        device=device)


def axis_net(params: dict, prefix: str, layers, z: torch.Tensor):
    """``z (1 - z) N(z)`` at nodes ``z`` (n, 1) -> (n, rank)."""
    h = z
    last = len(layers) - 2
    for i in range(len(layers) - 1):
        h = (h @ params[f"{prefix}layer_{i}.weight"].T
             + params[f"{prefix}layer_{i}.bias"].T)
        if i < last:
            h = torch.tanh(h)
    return z * (1 - z) * h


def features(params: dict, prefix: str, layers, z: torch.Tensor):
    """(F, F'') of one axis net at nodes ``z`` (n, 1)."""
    ones = torch.ones_like(z)

    def f(t):
        return axis_net(params, prefix, layers, t)

    def d1(t):
        return jvp(f, (t,), (ones,))[1]

    value = f(z)
    second = jvp(d1, (z,), (ones,))[1]
    return value, second


def loss_and_grads(params: dict, layers, n: int, dtype,
                   keep: int = 1) -> tuple:
    """(loss, {leaf: gradient}) of the grid residual; ``keep`` > 1 plants
    a fault for the control readings: the first 1/keep of the grid's rows
    alone, the mean taken over them."""
    for p in params.values():
        p.grad = None
    device = next(iter(params.values())).device
    z = nodes(n, device).to(dtype)[:, None]
    fx, fxx = features(params, "axis_0.", layers, z)
    fy, fyy = features(params, "axis_1.", layers, z)
    leaves = [t.detach().requires_grad_(True) for t in (fx, fxx, fy, fyy)]
    lx, lxx, ly, lyy = leaves
    src = torch.sin(math.pi * z[:, 0])     # both axes share the nodes
    total = torch.zeros((), dtype=torch.float64, device=device)
    kept = n // keep
    for s in range(0, kept, BLOCK_ROWS):
        rows = slice(s, min(s + BLOCK_ROWS, kept))
        r = (lxx[rows] @ ly.T + lx[rows] @ lyy.T
             + src[rows, None] * src[None, :])
        part = (r * r).sum() / (kept * n)
        part.backward()
        total += part.detach().double()
    torch.autograd.backward([fx, fxx, fy, fyy], [t.grad for t in leaves])
    return float(total), {k: p.grad.detach().clone()
                          for k, p in params.items()}


def follow(init: dict, layers, n: int, lr: float, steps: int,
           dtype, keep: int = 1) -> dict:
    """``steps`` Adam steps from ``init``; the same keys as
    `dense.follow`."""
    params = {k: v.detach().to(dtype).clone().requires_grad_(True)
              for k, v in init.items()}
    opt = Adam(params, lr)
    losses, first = [], None
    for _ in range(steps):
        loss, grads = loss_and_grads(params, layers, n, dtype, keep)
        losses.append(loss)
        if first is None:
            first = {k: float(g.double().norm()) for k, g in grads.items()}
        opt.step(params, grads)
    change = {k: float((params[k].detach().double() - init[k].double()).norm())
              for k in init}
    return {"losses": losses, "grad": first, "change": change}
