"""DeepONet (`neuralpde_tpu.nn.deeponet`; NeuralOperators.jl replacement for
PINOODE, reference: src/NeuralPDE.jl:19, src/pino_ode_solve.jl).

u(p, t) = Σ_k branch_k(p) · trunk_k(t): the branch takes the parameter
vector, the trunk the query coordinate; the output is their inner product
over the latent basis, shaped (T, P) as the reference's ``out[j, i]``
(src/pino_ode_solve.jl:106-132).

Parameters are named as the JAX package's tree: ``branch.layer_0.weight``,
``trunk.layer_0.weight``, and for `DeepONetPDE` also ``head`` and
``bias``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import default_float
from .core import Module, mlp, tanh


class DeepONet(Module):
    def __init__(self, branch: Module, trunk: Module):
        super().__init__()
        if branch.out_dim != trunk.out_dim:
            raise ValueError(
                f"branch/trunk latent dims differ: {branch.out_dim} vs "
                f"{trunk.out_dim}")
        self.branch = branch
        self.trunk = trunk

    @property
    def in_dim(self):
        return self.branch.in_dim

    @property
    def out_dim(self):
        return 1

    def reset_parameters(self, generator=None):
        self.branch.reset_parameters(generator)
        self.trunk.reset_parameters(generator)

    def forward(self, x):
        """x = (p, t): p (n_params, P), t (1, T) -> (T, P)."""
        p, t = x
        b = self.branch(p)                       # (K, P)
        tr = self.trunk(t)                       # (K, T)
        return tr.T @ b                          # (T, P)


class DeepONetPDE(Module):
    """Physics-informed DeepONet backbone for `solve_pino_pde` (Wang, Wang &
    Perdikaris 2021): ``u_o(x; p) = Σ_k W_ok · branch_k(p) · trunk_k(x) +
    b_o``.  The branch takes the scalar parameter columns ``(n_params, P)``,
    the trunk the d grid coordinates; the P×N field grid is one contraction.
    The trunk is pointwise in the coordinates, so the trained operator
    evaluates on any grid, uniform or not; it takes no function-valued
    inputs (those need an FNO backbone).

    ``forward((p, grids))`` with ``p`` ``(n_params, P)`` and ``grids`` the d
    coordinate arrays returns ``(N1..Nd, P)`` when ``out_channels == 1``,
    else ``(out_channels, N1..Nd, P)``.
    """

    def __init__(self, in_channels: int, grid_ndim: int, *,
                 latent: int = 64, branch_sizes=(64,), trunk_sizes=(64, 64),
                 out_channels: int = 1, activation=tanh):
        super().__init__()
        if in_channels < 1:
            raise ValueError("DeepONetPDE needs at least one scalar "
                             "parameter channel (function-valued inputs "
                             "need an FNO backbone)")
        self._in = in_channels
        self._out = out_channels
        self.grid_ndim = grid_ndim
        self.latent = latent
        self.branch = mlp([in_channels, *branch_sizes, latent], activation)
        self.trunk = mlp([grid_ndim, *trunk_sizes, latent], activation,
                         out_activation=activation)
        dtype = default_float()
        self.head = nn.Parameter(torch.empty((out_channels, latent),
                                             dtype=dtype))
        self.bias = nn.Parameter(torch.empty((out_channels,), dtype=dtype))
        self.reset_parameters()

    @property
    def in_dim(self):
        return self._in

    @property
    def out_dim(self):
        return self._out

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.branch.reset_parameters(generator)
        self.trunk.reset_parameters(generator)
        h = self.head
        h.copy_(torch.randn(h.shape, generator=generator, dtype=h.dtype,
                            device=h.device) / math.sqrt(self.latent))
        self.bias.zero_()

    def forward(self, x):
        p, grids = x
        if p.ndim != 2:
            raise ValueError(
                "DeepONetPDE takes scalar parameter columns (n_params, P); "
                f"got ndim={p.ndim} — function-valued operator inputs need "
                "an FNO backbone (FNO1D/2D/3D)")
        gs = [torch.as_tensor(g, dtype=p.dtype, device=p.device).reshape(-1)
              for g in grids]
        if len(gs) != self.grid_ndim:
            raise ValueError(f"DeepONetPDE(grid_ndim={self.grid_ndim}) got "
                             f"{len(gs)} grid axes")
        mesh = torch.meshgrid(*gs, indexing="ij")
        cord = torch.stack([m.reshape(-1) for m in mesh])
        b = self.branch(p)                                   # (K, P)
        t = self.trunk(cord)                                 # (K, N)
        # y[o, n, p] = sum_k head[o, k] t[k, n] b[k, p] + bias[o]
        y = torch.einsum("ok,kn,kp->onp", self.head, t, b)
        y = y + self.bias[:, None, None]
        shape = (self._out,) + tuple(g.shape[0] for g in gs) + (p.shape[1],)
        y = y.reshape(shape)
        return y[0] if self._out == 1 else y
