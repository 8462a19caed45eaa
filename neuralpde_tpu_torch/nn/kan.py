"""Kolmogorov-Arnold networks in the Chebyshev parameterization
(`neuralpde_tpu.nn.kan`; Liu et al. 2024 "KAN", ChebyKAN).

A KAN layer learns one univariate function per (input, output) edge and
sums over inputs: ``y_j = Σ_i φ_ij(x_i)``, each φ a degree-D Chebyshev
expansion of ``tanh(x_i)``.  The recurrence ``T_k = 2 t T_{k-1} - T_{k-2}``
is D elementwise ops and the layer contracts as one matmul
``(out, in·(D+1)) @ (in·(D+1), N)``.

The layer has a Taylor rule: ``t = tanh(x)`` goes through
`TAYLOR_RULES[tanh]` (at order 2 the `tanh_jet2` kernel), the recurrence
runs in truncated-Taylor arithmetic (`_Series`) and the contraction, being
linear, acts on every coefficient.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..config import default_float
from .core import TAYLOR_RULES, Chain, Module, _Series, tanh


class KANLayer(Module):
    """Chebyshev KAN layer: ``y_j = Σ_i Σ_k c_jik T_k(tanh(x_i))``.

    One parameter, ``coef`` of shape (out, in, degree+1), drawn normal with
    variance 1/(in·(degree+1)) so that the summed edge functions start O(1).
    """

    def __init__(self, in_dim: int, out_dim: int, degree: int = 5, *,
                 dtype=None, device=None):
        super().__init__()
        if degree < 1:
            raise ValueError(f"degree must be >= 1, got {degree}")
        self._in = in_dim
        self._out = out_dim
        self.degree = degree
        self.coef = nn.Parameter(torch.empty(
            (out_dim, in_dim, degree + 1), dtype=dtype or default_float(),
            device=device))
        self.reset_parameters()

    @property
    def in_dim(self):
        return self._in

    @property
    def out_dim(self):
        return self._out

    @property
    def has_taylor_rule(self):
        return True

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        c = self.coef
        std = 1.0 / math.sqrt(self._in * (self.degree + 1))
        c.copy_(std * torch.randn(tuple(c.shape), generator=generator,
                                  dtype=c.dtype, device=c.device))

    def _polys(self, t):
        """[T_0(t), ..., T_degree(t)] for a tensor or a `_Series` t."""
        one = (torch.ones_like(t) if isinstance(t, torch.Tensor) else
               _Series([torch.ones_like(t.c[0])] + [None] * (len(t.c) - 1)))
        polys = [one, t]
        for _ in range(self.degree - 1):
            polys.append(2.0 * t * polys[-1] - polys[-2])
        return polys

    def _contract(self, basis):
        """"oik,ikn->on" on a list of D+1 (in, N) tensors, as one matmul."""
        stacked = torch.stack(basis, dim=1)                 # (in, D+1, N)
        return self.coef.reshape(self._out, -1) @ stacked.reshape(
            -1, stacked.shape[-1])

    def forward(self, x, series=None):
        if series is None:
            return self._contract(self._polys(torch.tanh(x)))
        polys = self._polys(_Series.of(*TAYLOR_RULES[tanh](x, list(series))))
        zero = torch.zeros_like(x)
        out = _Series(
            self._contract([zero if p.c[k] is None else p.c[k] for p in polys])
            for k in range(len(series) + 1))
        return out.result()


def kan(sizes: Sequence[int], degree: int = 5, *, dtype=None,
        device=None) -> Chain:
    """Convenience constructor mirroring `mlp`: ``kan([2, 8, 8, 1])`` is a
    3-layer Chebyshev KAN.  No activations between layers: each layer is a
    learned nonlinearity (the tanh squash renormalizes between layers)."""
    return Chain(*[KANLayer(sizes[i], sizes[i + 1], degree, dtype=dtype,
                            device=device)
                   for i in range(len(sizes) - 1)])
