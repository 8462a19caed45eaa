"""Plain PyTorch reference of the dense 2-D Poisson PINN and its Adam steps.

The problem (the configuration's): ``u_xx + u_yy = -sin(pi x) sin(pi y)``
on the unit square, with ``u = 0`` on its four sides as four mean-square
boundary terms, each at ``bcs_points`` points; or, with ``hard_box``, the
trial function ``x (1 - x) y (1 - y) N(x, y)``, which is zero there.  The
loss is the mean square of the interior residual plus each side's mean
square.  ``N`` is a tanh MLP (weights ``(out, in)``, biases ``(out, 1)``).

Second derivatives are taken by reverse-mode autograd (a gradient of the
gradient), independent of the Taylor-mode arithmetic under test, in blocks
of points whose gradients are summed.  Points are drawn as the
configuration's sampling rule defines them: each step draws, from the
training generator, the interior points uniform on ``[h, 1 - h]^2`` with
``h = 1 / points``, then each side's in the order ``x = 0``, ``x = 1``,
``y = 0``, ``y = 1`` (the fixed coordinate drawn too and set), each as one
``(2, n)`` uniform float32 draw.  It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

SIDES = (((0.0, None), (0.0, None)), ((1.0, None), (1.0, None)),
         ((None, 0.0), (None, 0.0)), ((None, 1.0), (None, 1.0)))
BLOCK = 262_144


def draw_points(generator, points: int, bcs_points: int, device) -> list:
    """One step's float32 points: ``[interior (2, points), side 0, ...,
    side 3 (2, bcs_points)]``."""
    h = 1.0 / points

    def draw(n, lb, ub):
        lb = torch.tensor(lb, dtype=torch.float32, device=device)
        ub = torch.tensor(ub, dtype=torch.float32, device=device)
        u = torch.rand((2, n), generator=generator, dtype=torch.float32,
                       device=device)
        return u * (ub[:, None] - lb[:, None]) + lb[:, None]

    out = [draw(points, [h, h], [1 - h, 1 - h])]
    for lo, hi in SIDES:
        lb = [h if v is None else v for v in lo]
        ub = [1 - h if v is None else v for v in hi]
        out.append(draw(bcs_points, lb, ub))
    return out


def net(params: dict, x: torch.Tensor, layers, hard_box: bool):
    """The trial function at ``x`` (N, 2) -> (N,)."""
    h = x
    last = len(layers) - 2
    for i in range(len(layers) - 1):
        h = h @ params[f"layer_{i}.weight"].T + params[f"layer_{i}.bias"].T
        if i < last:
            h = torch.tanh(h)
    u = h[:, 0]
    if hard_box:
        u = x[:, 0] * (1 - x[:, 0]) * x[:, 1] * (1 - x[:, 1]) * u
    return u


def loss_and_grads(params: dict, pts: list, layers, hard_box: bool,
                   dtype, counts=None) -> tuple:
    """(loss, {leaf: gradient}) at one step's points; ``params`` are
    leaves of ``dtype`` that require gradients.  ``counts``: the number
    each term's sum is divided by (default: its points, a mean)."""
    for p in params.values():
        p.grad = None
    counts = counts or [t.shape[1] for t in pts]
    total = torch.zeros((), dtype=torch.float64, device=pts[0].device)
    interior = pts[0]
    n = counts[0]
    for s in range(0, n, BLOCK):
        x = interior[:, s:s + BLOCK].T.to(dtype).requires_grad_(True)
        u = net(params, x, layers, hard_box)
        g, = torch.autograd.grad(u.sum(), x, create_graph=True)
        lap = sum(torch.autograd.grad(g[:, d].sum(), x, create_graph=True)[0]
                  [:, d] for d in range(2))
        r = lap + torch.sin(math.pi * x[:, 0]) * torch.sin(math.pi * x[:, 1])
        part = (r * r).sum() / n
        part.backward()
        total += part.detach().double()
    for side, m in zip(pts[1:], counts[1:]):
        for s in range(0, side.shape[1], BLOCK):
            x = side[:, s:s + BLOCK].T.to(dtype)
            u = net(params, x, layers, hard_box)
            part = (u * u).sum() / m
            part.backward()
            total += part.detach().double()
    return float(total), {k: p.grad.detach().clone()
                          for k, p in params.items()}


class Adam:
    """optax.adam's rule (b1 0.9, b2 0.999, eps 1e-8), in the parameters'
    dtype."""

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


def follow(init: dict, layers, hard_box: bool, lr: float, generator,
           points: int, bcs_points: int, steps: int, dtype,
           keep: int = 1, mean_of_kept: bool = True) -> dict:
    """``steps`` Adam steps from ``init`` (float32 leaves) on the points
    drawn from ``generator``.  Returns ``{"losses": [loss at each step],
    "grad": {leaf: norm of the first gradient}, "change": {leaf: norm of
    the parameters' change after the steps}}``.

    ``keep`` > 1 plants a fault for the control readings: each term keeps
    the first 1/keep of its points, its sum divided by their number
    (``mean_of_kept``: half of the batch left out, the mean taken over the
    rest) or by all the points (a rank's share with the exchange between
    ranks left out)."""
    device = next(iter(init.values())).device
    params = {k: v.detach().to(dtype).clone().requires_grad_(True)
              for k, v in init.items()}
    opt = Adam(params, lr)
    losses, first = [], None
    for _ in range(steps):
        pts = draw_points(generator, points, bcs_points, device)
        counts = None
        if keep > 1:
            counts = [t.shape[1] // keep if mean_of_kept else t.shape[1]
                      for t in pts]
            pts = [t[:, :t.shape[1] // keep] for t in pts]
        loss, grads = loss_and_grads(params, pts, layers, hard_box, dtype,
                                     counts)
        losses.append(loss)
        if first is None:
            first = {k: float(g.double().norm()) for k, g in grads.items()}
        opt.step(params, grads)
    change = {k: float((params[k].detach().double() - init[k].double()).norm())
              for k in init}
    return {"losses": losses, "grad": first, "change": change}


def rms_error(params: dict, layers, hard_box: bool, n: int = 51) -> float:
    """RMS error of the trained trial function on the ``n x n`` grid of the
    unit square (nodes included) against the exact solution ``sin(pi x)
    sin(pi y) / (2 pi^2)``, in float64."""
    device = next(iter(params.values())).device
    xs = torch.linspace(0, 1, n, dtype=torch.float64, device=device)
    gx, gy = torch.meshgrid(xs, xs, indexing="ij")
    x = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)
    p64 = {k: v.detach().double() for k, v in params.items()}
    with torch.no_grad():
        got = net(p64, x, layers, hard_box)
    want = (torch.sin(math.pi * x[:, 0]) * torch.sin(math.pi * x[:, 1])
            / (2 * math.pi ** 2))
    return float(torch.sqrt(torch.mean((got - want) ** 2)))
