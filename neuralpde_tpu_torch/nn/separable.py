"""Separable (factorized) trial functions: the SPINN architecture
(`neuralpde_tpu.nn.separable`).

``u(x_1, ..., x_d) = sum_r prod_a f_a_r(x_a)`` with one small per-axis
network ``f_a : R -> R^rank`` (Cho et al. 2023).  On a tensor-product grid of
``N^d`` points the trial function and each pure partial ``d^k/dx_a^k`` need
only ``N d`` axis-network evaluations (the k-th Taylor coefficients of the
1-D axis net for the differentiated axis) and one rank contraction.

The axis networks are registered as ``axis_{a}``, so parameter names match
the JAX package's tree (``axis_0.layer_0.weight``).  ``forward(x)`` with
``x`` shaped ``(d, N)`` evaluates pointwise; the factorized grid evaluation
lives in `neuralpde_tpu_torch.compile.separable`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.derivatives import jet_series, jvp_derivative
from .core import Module, TrialFunction, mlp, tanh


class SeparableNet(Module):
    """Rank-``r`` separable trial function from per-axis networks, each
    mapping ``(1, N) -> (rank, N)``; all share one output rank."""

    def __init__(self, axis_nets: Sequence[Module]):
        super().__init__()
        nets = tuple(axis_nets)
        if not nets:
            raise ValueError("SeparableNet needs at least one axis network")
        ranks = {n.out_dim for n in nets}
        if len(ranks) != 1:
            raise ValueError(
                f"axis networks must share one output rank, got {sorted(ranks)}")
        for i, n in enumerate(nets):
            if n.in_dim != 1:
                raise ValueError(
                    f"axis network {i} must take a single scalar input "
                    f"(in_dim 1), got {n.in_dim}")
        for a, n in enumerate(nets):
            self.add_module(f"axis_{a}", n)
        self.rank = ranks.pop()

    @property
    def axis_nets(self):
        return tuple(self.children())

    @property
    def in_dim(self):
        return len(self.axis_nets)

    @property
    def out_dim(self):
        return 1

    def reset_parameters(self, generator=None):
        for net in self.axis_nets:
            net.reset_parameters(generator)

    def axis_series(self, params: dict, a: int, nodes,
                    order: int = 0) -> list:
        """``[F_0, ..., F_order]``: the ``(rank, N)`` features of axis ``a``
        at 1-D ``nodes`` and their exact derivatives up to ``order``, under
        the parameter dict ``params`` (this module's names).  One Taylor
        pass when the axis net has rules (its primal is ``F_0``), nested
        `torch.func.jvp` per order otherwise: a static choice by the net's
        type, with the same values either way."""
        prefix = f"axis_{a}."
        u = TrialFunction(self.axis_nets[a],
                          {k[len(prefix):]: v for k, v in params.items()
                           if k.startswith(prefix)})
        like = next(iter(u.params.values()), None)
        x = torch.as_tensor(nodes)
        if like is not None:
            x = x.to(device=like.device, dtype=like.dtype)
        x = x[None, :]
        if order == 0:
            return [u(x)]
        if u.has_taylor_rule:
            return jet_series(u, x, 0, order)
        return [u(x)] + [jvp_derivative(u, x, [0] * k, 1)
                         for k in range(1, order + 1)]

    def axis_features(self, params: dict, a: int, nodes,
                      order: int = 0) -> torch.Tensor:
        """``(rank, N)`` features of axis ``a`` at 1-D ``nodes``; ``order``
        > 0 gives the exact ``d^order`` features (see `axis_series`)."""
        return self.axis_series(params, a, nodes, order)[order]

    def forward(self, x):
        prod = None
        for a, net in enumerate(self.axis_nets):
            f = net(x[a:a + 1])                               # (rank, N)
            prod = f if prod is None else prod * f
        return torch.sum(prod, dim=0, keepdim=True)           # (1, N)

    def apply(self, params: dict, x) -> torch.Tensor:
        """Pointwise value ``(1, N)`` under ``params`` (the JAX signature)."""
        return TrialFunction(self, params)(x)

    def grid(self, params: dict, nodes_list) -> torch.Tensor:
        """Evaluate on the tensor-product grid of per-axis 1-D ``nodes_list``
        by one rank contraction: ``(N_1, ..., N_d)``."""
        if len(nodes_list) != len(self.axis_nets):
            raise ValueError(
                f"{len(self.axis_nets)} axes but {len(nodes_list)} node arrays")
        letters = "abcdefghij"[: len(nodes_list)]
        feats = [self.axis_features(params, a, n, 0)
                 for a, n in enumerate(nodes_list)]
        terms = ",".join(f"z{l}" for l in letters)
        return torch.einsum(f"{terms}->{letters}", *feats)


def separable_mlp(n_axes: int, hidden: Sequence[int] = (32, 32),
                  rank: int = 32, activation=tanh, *,
                  fourier_features: int | None = None,
                  fourier_sigma: float = 1.0, dtype=None,
                  device=None) -> SeparableNet:
    """One ``[1, *hidden, rank]`` MLP per axis (optionally behind a fixed
    random Fourier embedding)."""
    return SeparableNet([
        mlp([1, *hidden, rank], activation, fourier_features=fourier_features,
            fourier_sigma=fourier_sigma, dtype=dtype, device=device)
        for _ in range(n_axes)])
