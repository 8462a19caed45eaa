"""Adaptive loss weights (`neuralpde_tpu.adaptive`; reference:
src/adaptive_losses.jl).

Weights live in an explicit state dict of tensors on the problem's device,
threaded through the training step.  A scheme with ``reweight_every > 0``
computes a new state every that many iterations from the step's
per-equation losses (and, where it says so, the per-equation gradients);
`train` copies it into the carried state in place, so the step that
reweights can be captured as a CUDA graph.  New weights apply from the
following step, as in the JAX package.

All five reference schemes and the JAX package's sixth:
  NonAdaptiveLoss               (src/adaptive_losses.jl:22-42)
  GradientScaleAdaptiveLoss     (:75-151, Wang et al. 2020)
  MiniMaxAdaptiveLoss           (:183-239, McClenny & Braga-Neto)
  SoftAdaptAdaptiveLoss         (:284-364, Heydari et al. 2019)
  ReLoBRaLoAdaptiveLoss         (:408-491, Bischof & Kraus 2021)
  InverseDirichletAdaptiveLoss  (Maddu et al. 2022)

Every reweight is written in tensor ops on the state's device with Python
scalars for constants: nothing is read back to or copied from the host.
"""

from __future__ import annotations

import torch


def _vectorify(x, n, dtype, device):
    arr = torch.as_tensor(x, dtype=dtype, device=device)
    if arr.ndim == 0:
        arr = arr.expand(n)
    if arr.shape != (n,):
        raise ValueError(f"expected {n} weights, got shape {tuple(arr.shape)}")
    return arr.clone()


def _softmax(x):
    e = torch.exp(x - torch.max(x))
    return e / torch.sum(e)


def _flat_abs(grads):
    """|g| of every parameter of one component gradient, flattened."""
    return torch.cat([torch.abs(g.reshape(-1)) for g in grads])


class AbstractAdaptiveLoss:
    """Interface: init_state(n_pde, n_bc, dtype, device) and
    reweight(state, theta, pde_losses, bc_losses, component_grads,
    generator) -> new state.  ``component_grads`` is ``(pde_grads,
    bc_grads)``, one list of per-parameter gradients per equation, when
    `needs_component_grads`, else None."""

    def __init__(self, pde_loss_weights=1.0, bc_loss_weights=1.0,
                 additional_loss_weights=1.0):
        self.pde_loss_weights = pde_loss_weights
        self.bc_loss_weights = bc_loss_weights
        self.additional_loss_weights = additional_loss_weights
        self.reweight_every = 0  # 0 => never

    def _base_state(self, n_pde, n_bc, dtype, device):
        return {
            "pde_weights": _vectorify(self.pde_loss_weights, n_pde, dtype, device),
            "bc_weights": _vectorify(self.bc_loss_weights, n_bc, dtype, device),
            "additional_weights": _vectorify(self.additional_loss_weights, 1,
                                             dtype, device),
        }

    def init_state(self, n_pde, n_bc, dtype, device="cuda"):
        return self._base_state(n_pde, n_bc, dtype, device)

    @property
    def needs_component_grads(self) -> bool:
        return False

    def reweight(self, state, theta, pde_losses, bc_losses, component_grads,
                 generator):
        return state


class NonAdaptiveLoss(AbstractAdaptiveLoss):
    pass


class GradientScaleAdaptiveLoss(AbstractAdaptiveLoss):
    """BC weights <- EMA of max|∇pde_loss| / mean|∇bc_i_loss|."""

    def __init__(self, reweight_every: int, weight_change_inertia: float = 0.9,
                 **kw):
        super().__init__(**kw)
        self.reweight_every = reweight_every
        self.weight_change_inertia = weight_change_inertia

    @property
    def needs_component_grads(self) -> bool:
        return True

    def reweight(self, state, theta, pde_losses, bc_losses, component_grads,
                 generator):
        pde_grads, bc_grads = component_grads
        dtype = state["bc_weights"].dtype
        pde_max = torch.max(torch.stack([torch.max(_flat_abs(g))
                                         for g in pde_grads]))
        bc_mean = torch.stack([torch.mean(_flat_abs(g)) for g in bc_grads])
        eps = 1e-11 if dtype == torch.float64 else 1e-7
        proposed = pde_max / (bc_mean + eps)
        inertia = self.weight_change_inertia
        new_bc = inertia * state["bc_weights"] + (1 - inertia) * proposed
        return {**state, "bc_weights": new_bc.to(dtype)}


def adam_update(grad, mu, nu, count, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8):
    """One step of optax.adam's rule on tensors: returns ``(update, mu, nu,
    count)`` with ``update = -lr * mu_hat / (sqrt(nu_hat) + eps)``, the bias
    corrections at the incremented ``count`` (an integer tensor)."""
    mu = (1 - b1) * grad + b1 * mu
    nu = (1 - b2) * (grad * grad) + b2 * nu
    count = count + 1
    c = count.to(torch.float64)
    mu_hat = mu / (1 - b1 ** c).to(mu.dtype)
    nu_hat = nu / (1 - b2 ** c).to(nu.dtype)
    return -lr * (mu_hat / (torch.sqrt(nu_hat) + eps)), mu, nu, count


class MiniMaxAdaptiveLoss(AbstractAdaptiveLoss):
    """Inner gradient ascent on the weights: optax.adam's rule, its moments
    and step count carried in the state (``pde_mu``, ``pde_nu``,
    ``pde_count`` and the same for ``bc``)."""

    def __init__(self, reweight_every: int, pde_max_optimiser_lr: float = 1e-4,
                 bc_max_optimiser_lr: float = 0.5, **kw):
        super().__init__(**kw)
        self.reweight_every = reweight_every
        self.pde_max_optimiser_lr = pde_max_optimiser_lr
        self.bc_max_optimiser_lr = bc_max_optimiser_lr

    def init_state(self, n_pde, n_bc, dtype, device="cuda"):
        s = self._base_state(n_pde, n_bc, dtype, device)
        for kind in ("pde", "bc"):
            w = s[f"{kind}_weights"]
            s[f"{kind}_mu"] = torch.zeros_like(w)
            s[f"{kind}_nu"] = torch.zeros_like(w)
            s[f"{kind}_count"] = torch.zeros((), dtype=torch.int32,
                                             device=w.device)
        return s

    def reweight(self, state, theta, pde_losses, bc_losses, component_grads,
                 generator):
        new = dict(state)
        for kind, losses, lr in (("pde", pde_losses, self.pde_max_optimiser_lr),
                                 ("bc", bc_losses, self.bc_max_optimiser_lr)):
            w = state[f"{kind}_weights"]
            update, mu, nu, count = adam_update(
                -losses.to(w.dtype), state[f"{kind}_mu"], state[f"{kind}_nu"],
                state[f"{kind}_count"], lr)
            new.update({f"{kind}_weights": w + update, f"{kind}_mu": mu,
                        f"{kind}_nu": nu, f"{kind}_count": count})
        return new


class SoftAdaptAdaptiveLoss(AbstractAdaptiveLoss):
    """Softmax over normalized loss rates-of-change (gradient-free).

    ``smoothing`` EMA-mixes new weights with the previous ones (0.0 =
    reference-exact direct assignment, src/adaptive_losses.jl:313-364)."""

    def __init__(self, reweight_every: int, alpha: float = 0.1,
                 smoothing: float = 0.0, **kw):
        super().__init__(**kw)
        self.reweight_every = reweight_every
        self.alpha = alpha
        self.smoothing = smoothing

    def init_state(self, n_pde, n_bc, dtype, device="cuda"):
        s = self._base_state(n_pde, n_bc, dtype, device)
        s["prev_pde_losses"] = torch.zeros((n_pde,), dtype=dtype, device=device)
        s["prev_bc_losses"] = torch.zeros((n_bc,), dtype=dtype, device=device)
        s["initialized"] = torch.zeros((), dtype=torch.bool, device=device)
        return s

    def reweight(self, state, theta, pde_losses, bc_losses, component_grads,
                 generator):
        dtype = state["pde_weights"].dtype
        pde_losses = pde_losses.to(dtype)
        bc_losses = bc_losses.to(dtype)
        init = state["initialized"]
        prev_pde = torch.where(init, state["prev_pde_losses"], pde_losses)
        prev_bc = torch.where(init, state["prev_bc_losses"], bc_losses)
        all_losses = torch.cat([pde_losses, bc_losses])
        all_prev = torch.cat([prev_pde, prev_bc])
        rates = (all_losses - all_prev) / (all_prev + 1e-8)
        weights = _softmax(self.alpha * rates) * all_losses.shape[0]
        n_pde = pde_losses.shape[0]
        s = self.smoothing
        return {**state,
                "pde_weights": s * state["pde_weights"] + (1 - s) * weights[:n_pde],
                "bc_weights": s * state["bc_weights"] + (1 - s) * weights[n_pde:],
                "prev_pde_losses": pde_losses,
                "prev_bc_losses": bc_losses,
                "initialized": torch.ones_like(init)}


class ReLoBRaLoAdaptiveLoss(AbstractAdaptiveLoss):
    """Relative loss balancing with random lookback: with probability
    ``beta`` (one uniform draw from the generator) the reference losses are
    the previous ones, else the first.

    ``smoothing`` is the paper's exponential-decay mixing of new and previous
    weights (Bischof & Kraus 2021, their α); the default 0.0 is the
    reference's direct assignment (src/adaptive_losses.jl:442-491)."""

    def __init__(self, reweight_every: int, alpha: float = 1.0, beta: float = 0.9,
                 smoothing: float = 0.0, **kw):
        super().__init__(**kw)
        self.reweight_every = reweight_every
        self.alpha = alpha
        self.beta = beta
        self.smoothing = smoothing

    def init_state(self, n_pde, n_bc, dtype, device="cuda"):
        s = self._base_state(n_pde, n_bc, dtype, device)
        for k in ("init_pde_losses", "prev_pde_losses"):
            s[k] = torch.zeros((n_pde,), dtype=dtype, device=device)
        for k in ("init_bc_losses", "prev_bc_losses"):
            s[k] = torch.zeros((n_bc,), dtype=dtype, device=device)
        s["initialized"] = torch.zeros((), dtype=torch.bool, device=device)
        return s

    def reweight(self, state, theta, pde_losses, bc_losses, component_grads,
                 generator):
        dtype = state["pde_weights"].dtype
        pde_losses = pde_losses.to(dtype)
        bc_losses = bc_losses.to(dtype)
        init = state["initialized"]
        init_pde = torch.where(init, state["init_pde_losses"], pde_losses)
        init_bc = torch.where(init, state["init_bc_losses"], bc_losses)
        prev_pde = torch.where(init, state["prev_pde_losses"], pde_losses)
        prev_bc = torch.where(init, state["prev_bc_losses"], bc_losses)
        use_prev = torch.rand((), generator=generator, dtype=dtype,
                              device=init.device) < self.beta
        ref_pde = torch.where(use_prev, prev_pde, init_pde)
        ref_bc = torch.where(use_prev, prev_bc, init_bc)
        all_losses = torch.cat([pde_losses, bc_losses])
        all_ref = torch.cat([ref_pde, ref_bc])
        weights = (_softmax(self.alpha * all_losses / (all_ref + 1e-8))
                   * all_losses.shape[0])
        n_pde = pde_losses.shape[0]
        s = self.smoothing
        return {**state,
                "pde_weights": s * state["pde_weights"] + (1 - s) * weights[:n_pde],
                "bc_weights": s * state["bc_weights"] + (1 - s) * weights[n_pde:],
                "init_pde_losses": init_pde,
                "init_bc_losses": init_bc,
                "prev_pde_losses": pde_losses,
                "prev_bc_losses": bc_losses,
                "initialized": torch.ones_like(init)}


class InverseDirichletAdaptiveLoss(AbstractAdaptiveLoss):
    """Gradient-variance balancing (Maddu, Sturm, Müller & Sbalzarini 2022):
    component k gets weight ``γ_max / γ_k`` with ``γ_k = std(∇_θ L_k)``
    (population std over every parameter), EMA-mixed by
    ``weight_change_inertia``; PDE and BC weights both adapt."""

    def __init__(self, reweight_every: int,
                 weight_change_inertia: float = 0.9, **kw):
        super().__init__(**kw)
        self.reweight_every = reweight_every
        self.weight_change_inertia = weight_change_inertia

    @property
    def needs_component_grads(self) -> bool:
        return True

    def reweight(self, state, theta, pde_losses, bc_losses, component_grads,
                 generator):
        pde_grads, bc_grads = component_grads
        dtype = state["bc_weights"].dtype

        def gstd(g):
            flat = torch.cat([x.reshape(-1).to(dtype) for x in g])
            return torch.std(flat, correction=0)

        gammas = torch.stack([gstd(g) for g in list(pde_grads) + list(bc_grads)])
        eps = 1e-11 if dtype == torch.float64 else 1e-7
        proposed = (torch.max(gammas) / (gammas + eps)).to(dtype)
        n_pde = len(pde_grads)
        inertia = self.weight_change_inertia
        new_pde = inertia * state["pde_weights"] + (1 - inertia) * proposed[:n_pde]
        new_bc = inertia * state["bc_weights"] + (1 - inertia) * proposed[n_pde:]
        return {**state, "pde_weights": new_pde.to(dtype),
                "bc_weights": new_bc.to(dtype)}
