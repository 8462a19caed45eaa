"""Finite-basis PINNs (`neuralpde_tpu.nn.fbpinn`): overlapping-subdomain
partition-of-unity trial functions (Moseley, Markham & Nissen-Meyer 2023;
the multilevel hierarchy is Dolean, Heinlein, Mishra & Moseley 2024).

``u(x) = (1/L) Σ_l Σ_j w_lj(x) · f_lj((x - c_lj) / h_lj)`` over L levels of
tensor grids of overlapping box subdomains: each subdomain carries a small
local network seeing coordinates normalized to [-1, 1], and smooth
squared-cosine windows, normalized to a partition of unity per level, blend
them.  The windows are C² at the edge of their support (value, slope and
curvature vanish) and exactly zero outside it, so second-order residuals
see no jump.  Evaluating outside every window divides 0/0: keep points
inside the declared box.

All local nets of a level share one architecture, so a level is one stack
of batched matmuls over ``(J_l, in, N)`` (`torch.baddbmm`), with no loop
over subdomains.  Parameters are stacked on a leading ``(J_l,)`` axis:
``nets.layer_0.weight`` is ``(J, out, in)`` and the bias ``(J, out, 1)``
(``nets.<l>.layer_0.weight`` with several levels).

With an activation that has a Taylor rule the module has one: the
normalized coordinates are affine in x, the batched layers are linear, the
activation's rule takes the ``(J, hidden, N)`` tensors as they are (tanh at
order 2: the `tanh_jet2` kernel), and windows, normalization and blend run
in truncated-Taylor arithmetic (`_Series`).

Usage:
    net = FBPINN([(0, 1)], subdivisions=15, hidden=(16,))          # flat
    net = FBPINN([(0, 1)] * 2, levels=[1, 4, 16], hidden=(16,))    # multilevel
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..config import default_float
from .core import (
    TAYLOR_RULES, Module, _Series, _sin_cos_series, identity, tanh,
)


def _per_axis_subs(subdivisions, d):
    subs = ([int(subdivisions)] * d if np.isscalar(subdivisions)
            else [int(s) for s in subdivisions])
    if len(subs) != d or any(s < 1 for s in subs):
        raise ValueError(f"subdivisions {subs} must be >= 1 per axis")
    return subs


class _StackedDense(Module):
    """J Dense layers evaluated as one batched matmul: weight (J, out, in),
    bias (J, out, 1), input (J, in, N)."""

    def __init__(self, n_nets, in_dim, out_dim, activation, dtype, device):
        super().__init__()
        self.activation = activation or identity
        self.weight = nn.Parameter(torch.empty((n_nets, out_dim, in_dim),
                                               dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.empty((n_nets, out_dim, 1),
                                             dtype=dtype, device=device))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """glorot_uniform weights and zero biases, each net as `mlp`'s."""
        w = self.weight
        limit = math.sqrt(6.0 / (w.shape[1] + w.shape[2]))
        u = torch.rand(tuple(w.shape), generator=generator, dtype=w.dtype,
                       device=w.device)
        w.copy_((2 * u - 1) * limit)
        self.bias.zero_()

    def forward(self, x, series=None):
        z = torch.baddbmm(self.bias, self.weight, x)
        if series is None:
            return self.activation(z)
        a, a_series = TAYLOR_RULES[self.activation](
            z, [torch.bmm(self.weight, xk) for xk in series])
        return a, tuple(a_series)


class _StackedMLP(Module):
    """The J local nets of one level; children are named layer_0, ..."""

    def __init__(self, n_nets, sizes, activation, dtype, device):
        super().__init__()
        for i in range(len(sizes) - 1):
            act = activation if i < len(sizes) - 2 else None
            self.add_module(f"layer_{i}", _StackedDense(
                n_nets, sizes[i], sizes[i + 1], act, dtype, device))

    def reset_parameters(self, generator=None):
        for layer in self.children():
            layer.reset_parameters(generator)

    def forward(self, x, series=None):
        for layer in self.children():
            if series is None:
                x = layer(x)
            else:
                x, series = layer(x, series)
        return x if series is None else (x, series)


def _bump(s):
    """Squared-cosine bump on |s| < 1, exactly 0 outside: C² at the edge."""
    return torch.where(torch.abs(s) < 1.0,
                       (0.5 * (1.0 + torch.cos(math.pi * s))) ** 2,
                       torch.zeros_like(s))


class FBPINN(Module):
    """Partition-of-unity basis of local MLPs on subdomain grids.

    * ``bounds``: [(lo, hi)] per coordinate axis (the global box).
    * ``subdivisions``: subdomain count per axis (int or one per axis);
      the basis has ``prod(subdivisions)`` local nets.
    * ``levels``: instead of one ``subdivisions``, a list of per-level
      subdivision counts (each an int or per-axis tuple), e.g.
      ``levels=[1, 4, 16]``: a hierarchy whose output is the average of the
      per-level partition-of-unity blends.  Mutually exclusive with
      ``subdivisions``.
    * ``overlap``: fraction of the subdomain half-width shared with each
      neighbor (0 < overlap <= 1).
    * ``hidden``: hidden-layer sizes of every local net.
    """

    def __init__(self, bounds: Sequence, subdivisions=None, *,
                 levels: Sequence | None = None,
                 overlap: float = 0.5, hidden: Sequence[int] = (16,),
                 out_dim: int = 1, activation=tanh, dtype=None, device=None):
        super().__init__()
        bounds = [tuple(map(float, b)) for b in bounds]
        if not bounds or any(hi <= lo for lo, hi in bounds):
            raise ValueError(f"bounds must be non-empty (lo < hi): {bounds}")
        if not 0.0 < overlap <= 1.0:
            raise ValueError(f"overlap must be in (0, 1], got {overlap}")
        if levels is not None and subdivisions is not None:
            raise ValueError("pass subdivisions OR levels, not both")
        if levels is None:
            levels = [4 if subdivisions is None else subdivisions]
        if len(levels) < 1:
            raise ValueError("levels must be non-empty")
        d = len(bounds)
        self.bounds = bounds
        self.level_subs = [_per_axis_subs(s, d) for s in levels]
        self.subs = self.level_subs[0]
        self.overlap = float(overlap)
        self._out = out_dim
        self.activation = activation

        # per level: subdomain centers (J_l, d) and half-widths (d,).  Axis a
        # is split into subs[a] cells; each window spans its cell plus
        # `overlap` half-cells into the neighbors.
        self._centers, self._halfs = [], []
        for subs in self.level_subs:
            centers_1d, half = [], []
            for (lo, hi), n in zip(bounds, subs):
                cell = (hi - lo) / n
                centers_1d.append(lo + cell * (np.arange(n) + 0.5))
                half.append(cell / 2 * (1.0 + self.overlap))
            grids = np.meshgrid(*centers_1d, indexing="ij")
            self._centers.append(np.stack([g.ravel() for g in grids], axis=1))
            self._halfs.append(np.asarray(half))
        self.n_levels = len(self.level_subs)
        self.n_subdomains = sum(c.shape[0] for c in self._centers)
        self._geometry: dict = {}

        dtype = dtype or default_float()
        self.prepare(dtype, device)
        stacks = [_StackedMLP(c.shape[0], [d, *hidden, out_dim], activation,
                              dtype, device) for c in self._centers]
        self.nets = stacks[0] if self.n_levels == 1 else nn.ModuleList(stacks)

    @property
    def in_dim(self):
        return len(self.bounds)

    @property
    def out_dim(self):
        return self._out

    @property
    def has_taylor_rule(self):
        return self.activation in TAYLOR_RULES

    def reset_parameters(self, generator=None):
        for stack in self._stacks():
            stack.reset_parameters(generator)

    def _stacks(self):
        return [self.nets] if self.n_levels == 1 else list(self.nets)

    def prepare(self, dtype, device):
        """Make each level's centers (J, d, 1) and half-widths (d, 1) as
        tensors of ``dtype`` on ``device``, the only place where they are
        made: evaluations copy nothing from the host.  The constructor
        calls it for its own dtype and device, `symbolic_discretize` for
        the problem's."""
        made = [tuple(torch.as_tensor(a, dtype=dtype, device=device)[..., None]
                      for a in level)
                for level in zip(self._centers, self._halfs)]
        self._geometry[dtype, made[0][0].device] = made

    def _level_geometry(self, level: int, like: torch.Tensor):
        try:
            return self._geometry[like.dtype, like.device][level]
        except KeyError:
            raise RuntimeError(
                f"FBPINN: no subdomain geometry for {like.dtype} on "
                f"{like.device}; call net.prepare(dtype, device) first (it "
                f"holds {sorted(map(str, self._geometry))})") from None

    def _windows(self, x, level: int = 0):
        """Level-`level` normalized partition of unity at x (d, N) -> (J, N)."""
        c, h = self._level_geometry(level, x)
        w = torch.prod(_bump((x[None] - c) / h), dim=1)
        return w / torch.sum(w, dim=0, keepdim=True)

    def _apply_level(self, stack, x, level):
        c, h = self._level_geometry(level, x)
        s = (x[None] - c) / h                                   # (J, d, N)
        ys = stack(s)                                           # (J, out, N)
        w = torch.prod(_bump(s), dim=1)                         # (J, N)
        w = w / torch.sum(w, dim=0, keepdim=True)
        return torch.sum(w[:, None, :] * ys, dim=0)             # (out, N)

    def _apply_level_series(self, stack, x, series, level):
        c, h = self._level_geometry(level, x)
        s = (x[None] - c) / h
        # (x - c)/h is affine in x: higher coefficients scale by 1/h
        s_series = [(xk / h).expand_as(s) for xk in series]
        ys = _Series.of(*stack(s, s_series))                    # (J, out, N)

        inside = torch.abs(s) < 1.0
        _, _, cos_s, cos_series = _sin_cos_series(
            math.pi * s, [math.pi * sk for sk in s_series])
        g = 0.5 * (1.0 + _Series.of(cos_s, cos_series))
        bump = _Series(torch.where(inside, ck, torch.zeros_like(ck))
                       for ck in (g * g).c)                     # (J, d, N)
        w = bump[:, 0]
        for a in range(1, s.shape[1]):
            w = w * bump[:, a]                                  # (J, N)
        w = w / _Series(ck.sum(dim=0, keepdim=True) for ck in w.c)
        blend = w[:, None, :] * ys
        return _Series(ck.sum(dim=0) for ck in blend.c)         # (out, N)

    def forward(self, x, series=None):
        stacks = self._stacks()
        if series is None:
            total = self._apply_level(stacks[0], x, 0)
            for l in range(1, self.n_levels):
                total = total + self._apply_level(stacks[l], x, l)
            return total / self.n_levels if self.n_levels > 1 else total
        total = self._apply_level_series(stacks[0], x, series, 0)
        for l in range(1, self.n_levels):
            total = total + self._apply_level_series(stacks[l], x, series, l)
        if self.n_levels > 1:
            total = total / self.n_levels
        return total.result()
