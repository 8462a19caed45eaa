"""Hamiltonian Monte Carlo with Stan-style windowed warm-up
(`neuralpde_tpu.bayesian.hmc`; replaces AdvancedHMC.jl, reference:
ext/bpinn/advancedHMC_MCMC.jl:498-555).

A draw — momentum, the leapfrog trajectory, the Metropolis test, dual
averaging of the step size, the Welford window of the diagonal mass matrix
and its reset — updates a set of tensors in place.  Where the JAX package
branches with ``lax.cond`` on the iteration (``it < n_adapt``, ``it ==
w2``), the port selects with ``torch.where`` on an iteration counter that
is itself a device tensor, so a ``kernel="hmc"`` draw reads nothing back to
the host.  On the card the sampler runs its first draw eagerly, captures
the second as a CUDA graph (its generator registered, so each replay draws
fresh momenta) and replays that graph once per draw; a draw that cannot be
captured raises.  ``"hmcda"`` reads its step count ``round(λ/ε)`` once per
draw and replays a captured leapfrog step that many times; ``"nuts"``
(`bayesian.nuts`) builds its trajectory in a host loop over the same
captured leapfrog step.  On the CPU every draw runs eagerly.

The momentum normals and the accept uniforms come from one noise source:
`GeneratorNoise` (the default) or `NoiseTable`, which replays given draws
(a test hands it the JAX package's).

Kernels:
  * "hmc"   — fixed n_leapfrog steps (the reference default, n_leapfrog=30)
  * "hmcda" — trajectory length λ: n_steps = max(1, round(λ/ε)) per draw
  * "nuts"  — multinomial doubling with U-turn termination
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from ..kernels.tanh_jet import add_replayed, counts_since, launch_counts
from ..parallel.mesh import check_mesh, gather_ranks, mesh_slice, no_mesh
from ..train import _side_stream


class DualAveragingState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_sum: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def _da_init(eps0: torch.Tensor) -> DualAveragingState:
    log_eps = torch.log(eps0)
    return DualAveragingState(
        log_eps=log_eps, log_eps_avg=log_eps, h_sum=torch.zeros_like(eps0),
        mu=torch.log(10.0 * eps0), count=torch.zeros_like(eps0))


def _da_update(state: DualAveragingState, accept_prob, target):
    gamma, t0, kappa = 0.05, 10.0, 0.75
    count = state.count + 1.0
    h_sum = state.h_sum + (target - accept_prob)
    log_eps = state.mu - torch.sqrt(count) / gamma * h_sum / (count + t0)
    eta = count ** (-kappa)
    log_eps_avg = eta * log_eps + (1.0 - eta) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_sum, state.mu, count)


def _value_and_grad(logdensity: Callable) -> Callable:
    """q -> (logdensity(q), its gradient), by `torch.func`, so that it can
    be batched over chains and captured in a CUDA graph."""
    gv = grad_and_value(logdensity)

    def vg(q):
        g, v = gv(q)
        return v, g

    return vg


def _leapfrog(grad_fn, q, p, eps, inv_mass, n_steps):
    """``n_steps`` leapfrog steps (the JAX package's `_leapfrog`)."""
    for _ in range(n_steps):
        p = p + 0.5 * eps * grad_fn(q)
        q = q + eps * inv_mass * p
        p = p + 0.5 * eps * grad_fn(q)
    return q, p


def _leapfrog_step(vg, q, p, g, e, inv_mass):
    """One leapfrog step of signed size ``e`` from (q, p) with the gradient
    ``g`` at q -> (q, p, v, g) at the new position: each gradient is taken
    once and kept for the next step's first half."""
    p = p + 0.5 * e * g
    q = q + e * inv_mass * p
    v, g = vg(q)
    p = p + 0.5 * e * g
    return q, p, v, g


def find_good_stepsize(logdensity, q0, generator=None, init_eps=1.0,
                       max_iters=60):
    """AdvancedHMC-style heuristic: double/halve ε until the one-step
    acceptance crosses 0.5 (a host loop of a few evaluations)."""
    vg = _value_and_grad(logdensity)
    v0, g0 = vg(q0)
    p0 = torch.randn(q0.shape, generator=generator, dtype=q0.dtype,
                     device=q0.device)

    def h(v, p):
        return float(v - 0.5 * torch.sum(p * p))

    def one_step(eps):
        p = p0 + 0.5 * eps * g0
        q = q0 + eps * p
        v, g = vg(q)
        p = p + 0.5 * eps * g
        return h(v, p)

    h0 = h(v0, p0)
    eps = init_eps
    log_ratio = one_step(eps) - h0
    direction = 1.0 if log_ratio > math.log(0.5) else -1.0
    for _ in range(max_iters):
        eps = eps * (2.0**direction)
        if not np.isfinite(eps) or eps < 1e-10 or eps > 1e7:
            eps = min(max(eps, 1e-10), 1e7)
            break
        log_ratio = one_step(eps) - h0
        if not np.isfinite(log_ratio):
            eps = eps / (2.0**direction)
            break
        if (direction == 1.0) != (log_ratio > math.log(0.5)):
            break
    return float(eps)


def find_good_stepsize_traced(logdensity, q0, generator=None,
                              init_eps: float = 1.0, max_iters: int = 60):
    """The JAX package's traced search (its ``while_loop`` semantics:
    revert on a non-finite ratio, clip out of range, stop when the
    acceptance crosses 0.5), here a host loop; `sample_chains` runs it once
    per chain.  Returns ε as a 0-d tensor."""
    vg = _value_and_grad(logdensity)
    p0 = torch.randn(q0.shape, generator=generator, dtype=q0.dtype,
                     device=q0.device)
    v0, g0 = vg(q0)
    h0 = v0 - 0.5 * torch.sum(p0 * p0)
    log_half = math.log(0.5)

    def h_after(eps):
        p = p0 + 0.5 * eps * g0
        q = q0 + eps * p
        v, g = vg(q)
        p = p + 0.5 * eps * g
        return float(v - 0.5 * torch.sum(p * p) - h0)

    eps = float(init_eps)
    direction = 1.0 if h_after(eps) > log_half else -1.0
    for _ in range(max_iters):
        eps_new = eps * 2.0**direction
        out_of_range = (eps_new < 1e-10 or eps_new > 1e7
                        or not math.isfinite(eps_new))
        r = h_after(eps_new)
        nonfinite = not math.isfinite(r)
        crossed = (direction == 1.0) != (r > log_half)
        eps = eps if nonfinite else min(max(eps_new, 1e-10), 1e7)
        if out_of_range or nonfinite or crossed:
            break
    return torch.tensor(eps, dtype=q0.dtype, device=q0.device)


@dataclass
class SampleResult:
    samples: torch.Tensor      # (draws, dim)
    accept_prob: torch.Tensor  # (draws,)
    step_size: float
    inv_mass: torch.Tensor
    logdensities: torch.Tensor
    aux: dict = field(default_factory=dict)

    @property
    def stats(self):
        return {"accept_prob": self.accept_prob,
                "step_size": self.step_size,
                "logdensity": self.logdensities}

    def diagnostics(self, discard: int | None = None) -> dict:
        """ESS / split-R̂ / mean / std per parameter (the MCMCChains-summary
        analog; see `bayesian.diagnostics`).  ``discard`` drops warm-up
        draws first (default: the 2/3 warm-up used by `sample`)."""
        from .diagnostics import summarize

        n = self.samples.shape[0]
        discard = (2 * n) // 3 if discard is None else discard
        return summarize(self.samples[discard:])


# ---------------------------------------------------------------------------
# Noise sources
# ---------------------------------------------------------------------------

class GeneratorNoise:
    """Momentum normals and accept uniforms from a `torch.Generator`."""

    def __init__(self, generator):
        self.generator = generator

    def draw(self, it, shape, dtype, device):
        """-> (normals of ``shape``, uniforms of ``shape[:-1]``)."""
        z = torch.randn(shape, generator=self.generator, dtype=dtype,
                        device=device)
        u = torch.rand(tuple(shape[:-1]), generator=self.generator,
                       dtype=dtype, device=device)
        return z, u

    def rand(self, dtype, device):
        return torch.rand((), generator=self.generator, dtype=dtype,
                          device=device)


class NoiseTable:
    """Given draws, one row a draw: ``normals`` (draws, ..., dim) and
    ``uniforms`` (draws, ...), read at the draw's index (a device tensor),
    so a captured draw replays the next row."""

    def __init__(self, normals, uniforms):
        self.normals = torch.as_tensor(normals)
        self.uniforms = torch.as_tensor(uniforms)

    def draw(self, it, shape, dtype, device):
        # the tables move to the chain's device and dtype at the first
        # (eager) draw, so a captured draw reads them in place
        self.normals = self.normals.to(device=device, dtype=dtype)
        self.uniforms = self.uniforms.to(device=device, dtype=dtype)
        idx = it.reshape(1)
        z = self.normals.index_select(0, idx)
        u = self.uniforms.index_select(0, idx)
        return z.reshape(shape), u.reshape(tuple(shape[:-1]))


def _noise_source(noise, generator):
    return noise if noise is not None else GeneratorNoise(generator)


# ---------------------------------------------------------------------------
# CUDA graphs of in-place steps
# ---------------------------------------------------------------------------

class _Graphed:
    """An in-place step ``fn()``: eagerly when ``graphs`` is False; else its
    first call runs eagerly, its second is captured as a CUDA graph (with
    ``generator`` registered) and replayed, and every later call replays.
    A step that cannot be captured raises."""

    def __init__(self, fn, what: str, graphs: bool, generator=None):
        self.fn = fn
        self.what = what
        self.graphs = graphs
        self.generator = generator
        self.graph = None
        self.calls = 0
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0

    def __call__(self):
        self.calls += 1
        if not self.graphs or self.calls == 1:
            self.fn()
            return
        if self.graph is None:
            t0 = time.perf_counter()
            before = launch_counts()
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            try:
                with torch.cuda.graph(graph,
                                      stream=torch.cuda.current_stream()):
                    self.fn()
            except RuntimeError as e:
                raise RuntimeError(f"hmc: the {self.what} could not be "
                                   f"captured as a CUDA graph: {e}") from e
            self.graph = graph
            self.launched = counts_since(before)
            self.captures += 1
            self.capture_seconds += time.perf_counter() - t0
        self.graph.replay()
        add_replayed(self.launched)
        self.replays += 1

    def stats(self) -> dict:
        return {"captures": self.captures, "replays": self.replays,
                "capture_seconds": self.capture_seconds}


def _merge_stats(*steps) -> dict:
    out = {"captures": 0, "replays": 0, "capture_seconds": 0.0}
    for s in steps:
        for k, v in s.stats().items():
            out[k] += v
    return out


# ---------------------------------------------------------------------------
# The chain state and one draw
# ---------------------------------------------------------------------------

_STATE = ("q", "v", "g", "log_eps", "log_eps_avg", "h_sum", "mu", "count",
          "inv_mass", "mean", "m2", "cnt")


def _initial_state(vg, q0, init_step_size) -> dict:
    """Position, its log-density and gradient, dual averaging around
    ``init_step_size``, unit inverse mass, empty Welford window."""
    q0 = q0.detach().clone()
    v, g = vg(q0)
    eps0 = torch.as_tensor(init_step_size, dtype=q0.dtype, device=q0.device)
    da = _da_init(eps0)
    state = dict(q=q0, v=v.detach(), g=g.detach(), **da._asdict(),
                 inv_mass=torch.ones_like(q0), mean=torch.zeros_like(q0),
                 m2=torch.zeros_like(q0), cnt=torch.zeros_like(eps0))
    # tensors of their own: a draw updates each in place
    return {k: t.clone() for k, t in state.items()}


def _step_size(s: dict, it, n_adapt: int):
    return torch.exp(torch.where(it < n_adapt, s["log_eps"], s["log_eps_avg"]))


def _momentum(z, inv_mass):
    return z / torch.sqrt(inv_mass)


def _kinetic(p, inv_mass):
    return 0.5 * torch.sum(p * p * inv_mass)


def _metropolis(s: dict, p0, q1, p1, v1, g1, u):
    """Accept the trajectory's end with probability min(1, e^{ΔH}); a NaN
    probability counts as 0 (the JAX package's guard, kept as it is)."""
    h0 = s["v"] - _kinetic(p0, s["inv_mass"])
    h_new = v1 - _kinetic(p1, s["inv_mass"])
    log_ratio = h_new - h0
    accept_prob = torch.exp(torch.clamp(log_ratio, max=0.0))
    accept_prob = torch.where(torch.isnan(accept_prob),
                              torch.zeros_like(accept_prob), accept_prob)
    accept = u < accept_prob
    return (torch.where(accept, q1, s["q"]), torch.where(accept, v1, s["v"]),
            torch.where(accept, g1, s["g"]), accept_prob)


def _adapt(s: dict, q_new, accept_prob, it, n_adapt, w1, w2, target) -> dict:
    """Dual averaging while ``it < n_adapt``, the Welford window on
    [w1, w2), and at ``it == w2`` the inverse mass set to the window's
    variance with dual averaging restarted around the current step size:
    selections on the device, no host branch."""
    da = DualAveragingState(*(s[k] for k in DualAveragingState._fields))
    adapting = it < n_adapt
    new = _da_update(da, accept_prob, target)
    da = DualAveragingState(*(torch.where(adapting, a, b)
                              for a, b in zip(new, da)))
    in_window = (it >= w1) & (it < w2)
    cnt2 = torch.where(in_window, s["cnt"] + 1.0, s["cnt"])
    delta = q_new - s["mean"]
    mean2 = torch.where(in_window,
                        s["mean"] + delta / torch.clamp(cnt2, min=1.0),
                        s["mean"])
    m22 = torch.where(in_window, s["m2"] + delta * (q_new - mean2), s["m2"])
    reset = it == w2
    var = m22 / torch.clamp(cnt2 - 1.0, min=1.0)
    var = torch.where(var <= 1e-10, torch.ones_like(var), var)
    inv_mass = torch.where(reset, var, s["inv_mass"])
    restart = _da_init(torch.exp(da.log_eps))
    da = DualAveragingState(*(torch.where(reset, a, b)
                              for a, b in zip(restart, da)))
    return dict(**da._asdict(), inv_mass=inv_mass, mean=mean2, m2=m22,
                cnt=cnt2)


def _hmc_draw(vg, n_leapfrog, n_adapt, w1, w2, target):
    """One "hmc" draw as a function of (state, normals, uniform, it) ->
    (new state, accept probability): batched over chains by vmap."""
    def draw(s: dict, z, u, it):
        eps = _step_size(s, it, n_adapt)
        p0 = _momentum(z, s["inv_mass"])
        q1, p1, v1, g1 = s["q"], p0, s["v"], s["g"]
        for _ in range(n_leapfrog):
            q1, p1, v1, g1 = _leapfrog_step(vg, q1, p1, g1, eps, s["inv_mass"])
        q, v, g, accept_prob = _metropolis(s, p0, q1, p1, v1, g1, u)
        return (dict(q=q, v=v, g=g, **_adapt(s, q, accept_prob, it, n_adapt,
                                            w1, w2, target)), accept_prob)

    return draw


def _windows(n_adapt: int) -> tuple[int, int]:
    """Stan-ish schedule over warm-up: step size only before w1, the
    Welford window on [w1, w2), mass set at w2."""
    return int(0.15 * n_adapt), int(0.90 * n_adapt)


class _Chains:
    """Draw buffers and the in-place update of a state (one chain, or
    chains on a leading axis)."""

    def __init__(self, state: dict, draws: int):
        self.s = state
        q = state["q"]
        self.it = torch.zeros((), dtype=torch.int64, device=q.device)
        self.samples = torch.empty((draws, *q.shape), dtype=q.dtype,
                                   device=q.device)
        self.accept = torch.empty((draws, *q.shape[:-1]), dtype=q.dtype,
                                  device=q.device)
        self.lvals = torch.empty_like(self.accept)

    @torch.no_grad()
    def store(self, new: dict, accept_prob) -> None:
        for k, v in new.items():
            self.s[k].copy_(v.detach())
        idx = self.it.reshape(1)
        self.samples.index_copy_(0, idx, self.s["q"][None])
        self.accept.index_copy_(0, idx, accept_prob.detach()[None])
        self.lvals.index_copy_(0, idx, self.s["v"][None])
        self.it.add_(1)


def _sample_arrays(logdensity, q0, generator=None, draw_samples=1000, *,
                   kernel="hmc", n_leapfrog=30, target_accept=0.8, lam=1.0,
                   max_depth=10, n_adapt=None, init_step_size=1.0,
                   return_state=False, noise=None, graphs=None):
    """Array-only core of `sample`: ``(samples, accept, logdensities)``
    and, with ``return_state``, the final step size exp(log_eps_avg), the
    inverse mass and the CUDA-graph counts.  ``graphs`` (default: whether
    ``q0`` is on the card) replays captured draws."""
    q0 = torch.as_tensor(q0)
    n_adapt = n_adapt if n_adapt is not None else (2 * draw_samples) // 3
    w1, w2 = _windows(n_adapt)
    graphs = q0.is_cuda if graphs is None else graphs
    vg = _value_and_grad(logdensity)
    source = _noise_source(noise, generator)
    chain = _Chains(_initial_state(vg, q0, init_step_size), draw_samples)
    s = chain.s

    with _side_stream(q0):
        if kernel == "hmc":
            draw = _hmc_draw(vg, n_leapfrog, n_adapt, w1, w2, target_accept)

            def one():
                z, u = source.draw(chain.it, s["q"].shape, q0.dtype,
                                   q0.device)
                chain.store(*draw(s, z, u, chain.it))

            steps = [_Graphed(one, "hmc draw", graphs, generator)]
            for _ in range(draw_samples):
                steps[0]()
        elif kernel == "hmcda":
            steps = _run_hmcda(vg, chain, source, draw_samples, lam, n_adapt,
                               w1, w2, target_accept, graphs)
        else:
            raise ValueError(f"unknown kernel {kernel!r}")
    out = (chain.samples, chain.accept, chain.lvals)
    if return_state:
        return (*out, torch.exp(s["log_eps_avg"]), s["inv_mass"],
                _merge_stats(*steps))
    return out


class _Trajectory:
    """Static buffers of one leapfrog trajectory and its captured step:
    (q, p, g, v) advanced in place by a step of signed size ``e``."""

    def __init__(self, vg, like: torch.Tensor, graphs: bool):
        self.q, self.p, self.g = (torch.zeros_like(like) for _ in range(3))
        self.v = torch.zeros_like(like[..., 0])
        self.e = torch.zeros_like(like[..., 0])
        self.inv_mass = torch.ones_like(like)

        @torch.no_grad()
        def step():
            with torch.enable_grad():
                q, p, v, g = _leapfrog_step(vg, self.q, self.p, self.g,
                                            self.e, self.inv_mass)
            for buf, val in ((self.q, q), (self.p, p), (self.v, v),
                             (self.g, g)):
                buf.copy_(val.detach())

        self.step = _Graphed(step, "leapfrog step", graphs)

    @torch.no_grad()
    def load(self, q, p, g, e, inv_mass) -> None:
        for buf, val in ((self.q, q), (self.p, p), (self.g, g), (self.e, e),
                         (self.inv_mass, inv_mass)):
            buf.copy_(val)


def _run_hmcda(vg, chain, source, draws, lam, n_adapt, w1, w2, target,
               graphs):
    """"hmcda": per draw, n = clamp(round(λ/ε), 1, 4096) read on the host,
    then n replays of the captured leapfrog step."""
    s = chain.s
    traj = _Trajectory(vg, s["q"], graphs)
    for _ in range(draws):
        z, u = source.draw(chain.it, s["q"].shape, s["q"].dtype,
                           s["q"].device)
        eps = _step_size(s, chain.it, n_adapt)
        n_steps = int(torch.clamp(torch.round(lam / eps), 1, 4096))
        p0 = _momentum(z, s["inv_mass"])
        traj.load(s["q"], p0, s["g"], eps, s["inv_mass"])
        for _ in range(n_steps):
            traj.step()
        q, v, g, accept_prob = _metropolis(s, p0, traj.q, traj.p, traj.v,
                                           traj.g, u)
        chain.store(dict(q=q, v=v, g=g,
                         **_adapt(s, q, accept_prob, chain.it, n_adapt, w1,
                                  w2, target)), accept_prob)
    return [traj.step]


def sample(logdensity: Callable, q0, generator=None, draw_samples: int = 1000,
           *, kernel: str = "hmc", n_leapfrog: int = 30,
           target_accept: float = 0.8, lam: float = 1.0, max_depth: int = 10,
           n_adapt: int | None = None, init_step_size: float | None = None,
           progress: bool = False, seed: int = 0, noise=None, graphs=None):
    """Draw ``draw_samples`` positions on ``q0``'s device.  Warm-up (the
    first n_adapt ≈ 2/3 of the draws) adapts the step size by dual
    averaging and a diagonal mass matrix by Welford; all draws are
    returned (AdvancedHMC semantics: the caller slices off the ensemble
    tail).  ``generator`` (default: seeded with ``seed`` on ``q0``'s
    device) supplies the step-size search's momentum and, unless ``noise``
    replaces them, the draws' normals and uniforms.
    ``result.aux["cuda_graph"]`` counts captures and replays."""
    del progress
    q0 = torch.as_tensor(q0)
    if generator is None:
        generator = torch.Generator(device=q0.device).manual_seed(seed)
    if kernel == "nuts":
        from .nuts import nuts_sample
        return nuts_sample(logdensity, q0, generator, draw_samples,
                           target_accept=target_accept, max_depth=max_depth,
                           n_adapt=n_adapt, init_step_size=init_step_size,
                           graphs=graphs)
    if init_step_size is None:
        init_step_size = find_good_stepsize(logdensity, q0, generator)
    samples, accept, lvals, eps_f, inv_mass_f, stats = _sample_arrays(
        logdensity, q0, generator, draw_samples, kernel=kernel,
        n_leapfrog=n_leapfrog, target_accept=target_accept, lam=lam,
        max_depth=max_depth, n_adapt=n_adapt, init_step_size=init_step_size,
        return_state=True, noise=noise, graphs=graphs)
    return SampleResult(samples=samples, accept_prob=accept,
                        step_size=float(eps_f), inv_mass=inv_mass_f,
                        logdensities=lvals, aux={"cuda_graph": stats})


def sample_chains(logdensity, q0s, generator=None, draw_samples: int = 1000,
                  *, mesh=None, chain_axis: str = "data", seed: int = 0,
                  graphs=None, **kw):
    """Independent chains from the rows of ``q0s`` -> samples (chains,
    draws, dim).  Each chain's step size is searched once
    (`find_good_stepsize_traced`).  ``"hmc"`` chains are batched by
    `torch.func.vmap` (``randomness="different"``): one draw of all
    chains is one function, captured and replayed on the card like
    `sample`'s.  ``"hmcda"`` and ``"nuts"`` chains, whose trajectories
    have data-dependent lengths, run one after another.

    ``mesh`` (a `parallel.mesh.Mesh`) shards the chains over its ranks
    (their count a multiple of the mesh size): each rank runs its block of
    chains, without the mesh for their log-densities, and the draws are
    gathered, so every rank returns all of them.  Every rank searches the
    step sizes of all chains and, for ``"hmc"``, draws the noise of all
    chains and keeps its rows, so chain c's draws are those of the run
    without a mesh.  A rank's ``"hmcda"``/``"nuts"`` chains continue one
    another on its generator, as all chains do without a mesh, so there
    only the first rank's chains match that run."""
    del chain_axis
    mesh = check_mesh(mesh)
    q0s = torch.as_tensor(q0s)
    mine = (mesh_slice(len(q0s), mesh, "chains") if mesh is not None
            else slice(0, len(q0s)))
    if generator is None:
        generator = torch.Generator(device=q0s.device).manual_seed(seed)
    with no_mesh():
        samples = _chains(logdensity, q0s, generator, draw_samples, mine,
                          graphs, kw)
    return samples if mesh is None else gather_ranks(samples, mesh)


def _chains(logdensity, q0s, generator, draw_samples, mine, graphs, kw):
    """`sample_chains` of the chains ``mine`` -> (chains, draws, dim)."""
    kernel = kw.get("kernel", "hmc")
    eps = [find_good_stepsize_traced(logdensity, q0, generator)
           for q0 in q0s]
    if kernel == "nuts":
        from .nuts import _nuts_arrays

        kw2 = {k: v for k, v in kw.items()
               if k not in ("kernel", "n_leapfrog", "lam")}
        return torch.stack([
            _nuts_arrays(logdensity, q0, generator, draw_samples,
                         init_step_size=e, graphs=graphs, **kw2)[0]
            for q0, e in zip(q0s[mine], eps[mine])])
    if kernel != "hmc":
        return torch.stack([
            _sample_arrays(logdensity, q0, generator, draw_samples,
                           init_step_size=e, graphs=graphs, **kw)[0]
            for q0, e in zip(q0s[mine], eps[mine])])

    n_adapt = kw.get("n_adapt")
    n_adapt = n_adapt if n_adapt is not None else (2 * draw_samples) // 3
    w1, w2 = _windows(n_adapt)
    vg = _value_and_grad(logdensity)
    states = [_initial_state(vg, q0, e)
              for q0, e in zip(q0s[mine], eps[mine])]
    chain = _Chains({k: torch.stack([st[k] for st in states])
                     for k in _STATE}, draw_samples)
    draw = vmap(_hmc_draw(vg, kw.get("n_leapfrog", 30), n_adapt, w1, w2,
                          kw.get("target_accept", 0.8)),
                in_dims=(0, 0, 0, None), randomness="different")
    source = GeneratorNoise(generator)
    s = chain.s
    every = len(q0s) != s["q"].shape[0]

    def one():
        # the noise of every chain, then this rank's rows
        z, u = source.draw(chain.it, q0s.shape, q0s.dtype, q0s.device)
        if every:
            z, u = z[mine], u[mine]
        chain.store(*draw(s, z, u, chain.it))

    step = _Graphed(one, "hmc draw of the chains",
                    q0s.is_cuda if graphs is None else graphs, generator)
    with _side_stream(q0s):
        for _ in range(draw_samples):
            step()
    return chain.samples.transpose(0, 1)
