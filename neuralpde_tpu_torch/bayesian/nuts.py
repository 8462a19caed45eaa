"""No-U-Turn Sampler: iterative multinomial doubling
(`neuralpde_tpu.bayesian.nuts`; replaces the reference's AdvancedHMC NUTS
kernel, ext/bpinn/advancedHMC_MCMC.jl:265-274).

The NUTS variant of Stan/AdvancedHMC: multinomial sampling over the
trajectory, generalized U-turn termination, subtrees built iteratively with
the checkpoint bit trick for the U-turn checks inside a subtree (the
leaf->checkpoint index map of Phan et al., NumPyro), checkpoint arrays
``(max_depth, dim)``.  How far a trajectory doubles depends on the data, so
the tree is built in a host loop: each leaf is one replay of the captured
leapfrog step of `bayesian.hmc` (on the card) and one host read of its
U-turn and divergence flags.  Warm-up is `hmc`'s.

Energy convention: H(q, p) = -logdensity(q) + 0.5 pᵀ M⁻¹ p; multinomial
leaf weight log w = -H.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..train import _side_stream
from .hmc import (
    GeneratorNoise, SampleResult, _adapt, _Chains, _initial_state,
    _merge_stats, _momentum, _step_size, _Trajectory, _value_and_grad,
    _windows, find_good_stepsize,
)


class _Leaf(NamedTuple):
    q: torch.Tensor
    p: torch.Tensor
    grad: torch.Tensor
    logdens: torch.Tensor


def _is_turning(p_left, p_right, p_sum, inv_mass):
    v = p_sum * inv_mass
    return (torch.dot(v, p_left) <= 0.0) | (torch.dot(v, p_right) <= 0.0)


def _leaf_to_ckpt_idxs(n: int) -> tuple[int, int]:
    """(idx_min, idx_max) of the checkpoints that leaf n is compared with."""
    idx_max = bin(n >> 1).count("1")
    num_subtrees = 0
    while (n >> num_subtrees) & 1:
        num_subtrees += 1
    return idx_max - num_subtrees + 1, idx_max


def nuts_sample(logdensity, q0, generator=None, draw_samples: int = 1000, *,
                target_accept: float = 0.8, max_depth: int = 10,
                n_adapt: int | None = None, init_step_size: float | None = None,
                delta_max: float = 1000.0, graphs=None, seed: int = 0):
    q0 = torch.as_tensor(q0)
    if generator is None:
        generator = torch.Generator(device=q0.device).manual_seed(seed)
    if init_step_size is None:
        init_step_size = find_good_stepsize(logdensity, q0, generator)
    samples, accept, lvals, eps_f, inv_mass_f, stats = _nuts_arrays(
        logdensity, q0, generator, draw_samples, target_accept=target_accept,
        max_depth=max_depth, n_adapt=n_adapt, init_step_size=init_step_size,
        delta_max=delta_max, return_state=True, graphs=graphs)
    return SampleResult(samples=samples, accept_prob=accept,
                        step_size=float(eps_f), inv_mass=inv_mass_f,
                        logdensities=lvals, aux={"cuda_graph": stats})


class _Tree:
    """One NUTS transition's trajectory, built leaf by leaf."""

    def __init__(self, traj: _Trajectory, noise: GeneratorNoise, eps,
                 inv_mass, h0, max_depth: int, delta_max: float):
        self.traj = traj
        self.noise = noise
        self.eps = eps
        self.inv_mass = inv_mass
        self.h0 = h0
        self.max_depth = max_depth
        self.delta_max = delta_max

    def _log_uniform(self, like):
        return torch.log(self.noise.rand(like.dtype, like.device))

    def _leapfrog(self, leaf: _Leaf, direction: float) -> _Leaf:
        self.traj.load(leaf.q, leaf.p, leaf.grad, self.eps * direction,
                       self.inv_mass)
        self.traj.step()
        t = self.traj
        return _Leaf(t.q.clone(), t.p.clone(), t.g.clone(), t.v.clone())

    def _neg_energy(self, leaf: _Leaf):
        return leaf.logdens - 0.5 * torch.sum(leaf.p * leaf.p * self.inv_mass)

    def subtree(self, edge: _Leaf, depth: int, direction: float):
        """Extend ``edge`` by up to 2^depth leapfrog steps -> (far edge,
        proposal, log weight, momentum sum, turning, diverging, summed
        acceptance, leaves)."""
        dim = edge.q.shape[0]
        leaf, prop_q = edge, edge.q
        logw = torch.full_like(self.h0, -math.inf)
        p_sum = torch.zeros_like(edge.p)
        sum_acc = torch.zeros_like(self.h0)
        p_ckpts = torch.zeros((self.max_depth, dim), dtype=edge.q.dtype,
                              device=edge.q.device)
        psum_ckpts = torch.zeros_like(p_ckpts)
        turning = diverging = False
        for leaf_idx in range(2 ** depth):
            new = self._leapfrog(leaf, direction)
            ne = self._neg_energy(new)
            div = (self.h0 - ne) > self.delta_max
            logw_new = ne - self.h0
            logw_tot = torch.logaddexp(logw, logw_new)
            take = self._log_uniform(ne) < (logw_new - logw_tot)
            prop_q = torch.where(take, new.q, prop_q)
            p_sum = p_sum + new.p
            acc = torch.clamp(torch.exp(logw_new), max=1.0)
            sum_acc = sum_acc + torch.where(torch.isnan(acc),
                                            torch.zeros_like(acc), acc)
            idx_min, idx_max = _leaf_to_ckpt_idxs(leaf_idx)
            if leaf_idx % 2 == 0:
                p_ckpts[idx_max] = new.p
                psum_ckpts[idx_max] = p_sum
                turn = torch.zeros_like(div)
            else:
                i = slice(idx_min, idx_max + 1)
                seg = p_sum[None] - psum_ckpts[i] + p_ckpts[i]
                v = seg * self.inv_mass       # _is_turning at each checkpoint
                turn = (((v * p_ckpts[i]).sum(-1) <= 0.0)
                        | ((v @ new.p) <= 0.0)).any()
            leaf, logw = new, logw_tot
            turning, diverging = torch.stack([turn, div]).tolist()
            if turning or diverging:
                break
        return (leaf, prop_q, logw, p_sum, turning, diverging, sum_acc,
                2 ** depth)

    def build(self, start: _Leaf):
        """-> (proposal, mean acceptance over the trajectory)."""
        left = right = start
        prop_q, logw, p_sum = start.q, torch.zeros_like(self.h0), start.p
        sum_acc, n_steps = torch.zeros_like(self.h0), 0
        depth, turning, diverging = 0, False, False
        while not turning and not diverging and depth < self.max_depth:
            go_right = bool(self.noise.rand(self.h0.dtype, self.h0.device)
                            < 0.5)
            edge = right if go_right else left
            (far, prop_new, logw_new, p_sum_new, turning_new, diverging_new,
             acc_new, n_new) = self.subtree(edge, depth,
                                            1.0 if go_right else -1.0)
            if go_right:
                right = far
            else:
                left = far
            valid = not turning_new and not diverging_new
            log_u = self._log_uniform(self.h0)
            if valid:
                # biased progressive sampling: P(take new) = w_new / w_old
                prop_q = torch.where(log_u < (logw_new - logw), prop_new,
                                     prop_q)
                logw = torch.logaddexp(logw, logw_new)
                p_sum = p_sum + p_sum_new
                turning = bool(_is_turning(left.p, right.p, p_sum,
                                           self.inv_mass))
            turning = turning or turning_new
            diverging = diverging_new
            sum_acc = sum_acc + acc_new
            n_steps += n_new
            depth += 1
        return prop_q, sum_acc / max(n_steps, 1)


def _nuts_arrays(logdensity, q0, generator=None, draw_samples: int = 1000, *,
                 target_accept: float = 0.8, max_depth: int = 10,
                 n_adapt: int | None = None, init_step_size=1.0,
                 delta_max: float = 1000.0, return_state: bool = False,
                 graphs=None):
    """Array-only NUTS core: ``(samples, accept, logdensities)`` and, with
    ``return_state``, the final step size, inverse mass and CUDA-graph
    counts."""
    q0 = torch.as_tensor(q0)
    n_adapt = n_adapt if n_adapt is not None else (2 * draw_samples) // 3
    w1, w2 = _windows(n_adapt)
    graphs = q0.is_cuda if graphs is None else graphs
    vg = _value_and_grad(logdensity)
    noise = GeneratorNoise(generator)
    chain = _Chains(_initial_state(vg, q0, init_step_size), draw_samples)
    s = chain.s
    traj = _Trajectory(vg, q0, graphs)

    with _side_stream(q0):
        for _ in range(draw_samples):
            z = torch.randn(q0.shape, generator=generator, dtype=q0.dtype,
                            device=q0.device)
            eps = _step_size(s, chain.it, n_adapt)
            p = _momentum(z, s["inv_mass"])
            start = _Leaf(s["q"].clone(), p, s["g"].clone(), s["v"].clone())
            h0 = start.logdens - 0.5 * torch.sum(p * p * s["inv_mass"])
            tree = _Tree(traj, noise, eps, s["inv_mass"].clone(), h0,
                         max_depth, delta_max)
            prop_q, accept_prob = tree.build(start)
            with torch.enable_grad():
                v, g = vg(prop_q)
            chain.store(dict(q=prop_q, v=v, g=g,
                             **_adapt(s, prop_q, accept_prob, chain.it,
                                      n_adapt, w1, w2, target_accept)),
                        accept_prob)
    out = (chain.samples, chain.accept, chain.lvals)
    if return_state:
        return (*out, torch.exp(s["log_eps_avg"]), s["inv_mass"],
                _merge_stats(traj.step))
    return out
