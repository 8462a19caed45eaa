"""Adaptive loss weights: the state and reweight contract of
`neuralpde_tpu.adaptive`.

Weights live in an explicit state dict of tensors threaded through the
training step; a scheme with `reweight_every > 0` replaces the state every
that many iterations.  Only `NonAdaptiveLoss` is ported so far.
"""

from __future__ import annotations

import torch


def _vectorify(x, n, dtype, device):
    arr = torch.as_tensor(x, dtype=dtype, device=device)
    if arr.ndim == 0:
        arr = arr.expand(n).clone()
    if arr.shape != (n,):
        raise ValueError(f"expected {n} weights, got shape {tuple(arr.shape)}")
    return arr


class AbstractAdaptiveLoss:
    """Interface: init_state(n_pde, n_bc, dtype, device) and
    reweight(state, theta, pde_losses, bc_losses, component_grads, generator)."""

    def __init__(self, pde_loss_weights=1.0, bc_loss_weights=1.0,
                 additional_loss_weights=1.0):
        self.pde_loss_weights = pde_loss_weights
        self.bc_loss_weights = bc_loss_weights
        self.additional_loss_weights = additional_loss_weights
        self.reweight_every = 0  # 0 => never

    def _base_state(self, n_pde, n_bc, dtype, device=None):
        return {
            "pde_weights": _vectorify(self.pde_loss_weights, n_pde, dtype, device),
            "bc_weights": _vectorify(self.bc_loss_weights, n_bc, dtype, device),
            "additional_weights": _vectorify(self.additional_loss_weights, 1,
                                             dtype, device),
        }

    def init_state(self, n_pde, n_bc, dtype, device=None):
        return self._base_state(n_pde, n_bc, dtype, device)

    @property
    def needs_component_grads(self) -> bool:
        return False

    def reweight(self, state, theta, pde_losses, bc_losses, component_grads,
                 generator):
        return state


class NonAdaptiveLoss(AbstractAdaptiveLoss):
    pass
