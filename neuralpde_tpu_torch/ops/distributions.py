"""Minimal distribution toolkit (`neuralpde_tpu.ops.distributions`; a
Distributions.jl replacement).

Gaussian and friends for likelihoods and priors (reference usage:
src/training_strategies.jl:119-127, ext/bpinn/advancedHMC_MCMC.jl:229-254).
``logpdf`` takes a tensor, and returns one on its device and in its dtype,
or a Python number, and returns a Python float.  Parameters (``mu``,
``sigma``, bounds) are Python numbers, so a log-density creates no tensor
of its own and can be captured in a CUDA graph.  ``sample(generator,
shape)`` draws on the generator's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def _log(v):
    return torch.log(v) if isinstance(v, torch.Tensor) else math.log(v)


def _as_tensor(x):
    """(tensor, whether ``x`` was a Python number)."""
    if isinstance(x, torch.Tensor):
        return x, False
    scalar = isinstance(x, (int, float))
    return torch.as_tensor(x, dtype=torch.float64), scalar


def _out(v: torch.Tensor, scalar: bool):
    return float(v) if scalar else v


def normal_logpdf(x, mu, sigma):
    z = (x - mu) / sigma
    return -0.5 * z * z - _log(sigma) - 0.5 * _LOG_2PI


def mvnormal_diag_logpdf(x, mu, sigma):
    """Σ_i log N(x_i; mu_i, sigma_i): the reference's
    ``logpdf(MvNormal(mu, Diagonal(sigma²)), x)``."""
    return torch.sum(normal_logpdf(x, mu, sigma))


def _draw(generator, shape, fn):
    device = generator.device if generator is not None else None
    return fn(tuple(shape), generator=generator, device=device,
              dtype=torch.get_default_dtype())


@dataclass(frozen=True)
class Normal:
    mu: float = 0.0
    sigma: float = 1.0

    def logpdf(self, x):
        if isinstance(x, torch.Tensor):
            return normal_logpdf(x, self.mu, self.sigma)
        t, scalar = _as_tensor(x)
        return _out(normal_logpdf(t, self.mu, self.sigma), scalar)

    @property
    def mean(self):
        return self.mu

    def sample(self, generator=None, shape=()):
        return self.mu + self.sigma * _draw(generator, shape, torch.randn)


@dataclass(frozen=True)
class Uniform:
    lo: float = 0.0
    hi: float = 1.0

    def logpdf(self, x):
        t, scalar = _as_tensor(x)
        inside = (t >= self.lo) & (t <= self.hi)
        out = torch.where(inside, -math.log(self.hi - self.lo), -math.inf)
        return _out(out.to(t.dtype), scalar)

    @property
    def mean(self):
        return 0.5 * (self.lo + self.hi)

    def sample(self, generator=None, shape=()):
        u = _draw(generator, shape, torch.rand)
        return self.lo + (self.hi - self.lo) * u


@dataclass(frozen=True)
class LogNormal:
    mu: float = 0.0
    sigma: float = 1.0

    def logpdf(self, x):
        t, scalar = _as_tensor(x)
        safe = torch.clamp(t, min=1e-300)
        out = torch.where(
            t > 0,
            normal_logpdf(torch.log(safe), self.mu, self.sigma)
            - torch.log(safe),
            -math.inf)
        return _out(out, scalar)

    @property
    def mean(self):
        return math.exp(self.mu + 0.5 * self.sigma**2)

    def sample(self, generator=None, shape=()):
        return torch.exp(self.mu
                         + self.sigma * _draw(generator, shape, torch.randn))


class Particles:
    """Ensemble value summary (MonteCarloMeasurements.Particles analog,
    reference: src/NeuralPDE.jl:48): holds a tensor of samples on axis 0."""

    def __init__(self, samples):
        self.samples = torch.as_tensor(samples)

    @property
    def mean(self):
        return torch.mean(self.samples, dim=0)

    @property
    def std(self):
        return torch.std(self.samples, dim=0, correction=0)

    def quantile(self, q):
        return torch.quantile(self.samples, q, dim=0)

    def __repr__(self):
        return f"Particles(n={self.samples.shape[0]}, mean={self.mean})"
