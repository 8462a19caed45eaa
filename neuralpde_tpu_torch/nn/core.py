"""Dense networks as `nn.Module`s, with Taylor-mode propagation.

Layout as in `neuralpde_tpu.nn.core`: weight ``(out, in)``, bias
``(out, 1)``, coordinates ``(dim, N)`` with the batch on the last axis.
`Chain` names its layers ``layer_{i}``, so parameter names
(``layer_0.weight``) match the JAX package's pytree paths.

Training code keeps parameters outside the module, in a flat dict, and
evaluates with `torch.func.functional_call` (see `TrialFunction`).

``forward(x, series)`` propagates a truncated Taylor series in the derivative
convention of `jax.experimental.jet`: ``series[k-1]`` is the k-th derivative
of the input along a path, and the result holds the output's.  A Dense layer
is linear (its bias goes on the primal only); each activation has a rule in
`TAYLOR_RULES`.  tanh at order 2 runs the `tanh_jet2` kernel; every other
(activation, order) pair runs the plain recurrences below, on any device.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import nn
from torch.func import functional_call

from ..config import default_float
from ..kernels.tanh_jet import tanh_jet2


# ---------------------------------------------------------------------------
# Initializers (glorot_uniform matches Lux's Dense default weight init)
# ---------------------------------------------------------------------------

def glorot_uniform(generator, shape, dtype=None, device=None):
    fan_out, fan_in = shape[0], shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=dtype or default_float(),
                   device=device)
    return (2 * u - 1) * limit


def glorot_normal(generator, shape, dtype=None, device=None):
    fan_out, fan_in = shape[0], shape[1]
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(shape, generator=generator,
                             dtype=dtype or default_float(), device=device)


def zeros_init(generator, shape, dtype=None, device=None):
    del generator
    return torch.zeros(shape, dtype=dtype or default_float(), device=device)


# ---------------------------------------------------------------------------
# Activations (the JAX package's set, with the same definitions)
# ---------------------------------------------------------------------------

tanh = torch.tanh
sigmoid = torch.sigmoid
relu = torch.relu
sin = torch.sin


def gelu(x):
    return nn.functional.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def swish(x):
    return nn.functional.silu(x)


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))     # jax.nn.softplus


def identity(x):
    return x


# ---------------------------------------------------------------------------
# Taylor rules: (z, [z_1..z_K]) -> (a, [a_1..a_K]), derivative convention.
# Internally on normalised coefficients c_k = z_k / k!, where a' = g(a) z'
# turns into k c^a_k = sum_{j=1..k} j c^z_j c^g_{k-j}.
# ---------------------------------------------------------------------------

def _normalise(zs):
    return [zk / math.factorial(k) for k, zk in enumerate(zs, start=1)]


def _denormalise(cs):
    return [ck * math.factorial(k) for k, ck in enumerate(cs[1:], start=1)]


def _ode_step(zt, g, k):
    """k-th normalised coefficient of a with a' = g z' (zt[j-1] = c^z_j)."""
    return sum(j * zt[j - 1] * g[k - j] for j in range(1, k + 1)) / k


def _square_coeff(c, m):
    """m-th normalised coefficient of (sum_i c_i t^i)^2."""
    return sum(c[i] * c[m - i] for i in range(m + 1))


def _tanh_series(z, zs):
    if len(zs) == 2:
        a, a1, a2 = tanh_jet2(z, zs[0], zs[1])
        return a, [a1, a2]
    zt = _normalise(zs)
    a = [torch.tanh(z)]
    s = [1 - a[0] * a[0]]                                  # s = 1 - a^2
    for k in range(1, len(zs) + 1):
        a.append(_ode_step(zt, s, k))
        if k < len(zs):
            s.append(-_square_coeff(a, k))
    return a[0], _denormalise(a)


def _sigmoid_series(z, zs):
    zt = _normalise(zs)
    a = [torch.sigmoid(z)]
    q = [a[0] - a[0] * a[0]]                               # q = a - a^2
    for k in range(1, len(zs) + 1):
        a.append(_ode_step(zt, q, k))
        if k < len(zs):
            q.append(a[k] - _square_coeff(a, k))
    return a[0], _denormalise(a)


def _sin_series(z, zs):
    zt = _normalise(zs)
    s, c = [torch.sin(z)], [torch.cos(z)]                  # s' = c z', c' = -s z'
    for k in range(1, len(zs) + 1):
        s.append(_ode_step(zt, c, k))
        c.append(-_ode_step(zt, s, k))
    return s[0], _denormalise(s)


def _identity_series(z, zs):
    return z, list(zs)


TAYLOR_RULES: dict[Callable, Callable] = {
    tanh: _tanh_series,
    sigmoid: _sigmoid_series,
    sin: _sin_series,
    identity: _identity_series,
}


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Module(nn.Module):
    """Base class.  ``forward(x)`` maps ``(in_dim, N)`` to ``(out_dim, N)``;
    modules with `has_taylor_rule` also take ``forward(x, series)``."""

    @property
    def in_dim(self) -> int:
        raise NotImplementedError

    @property
    def out_dim(self) -> int:
        raise NotImplementedError

    @property
    def has_taylor_rule(self) -> bool:
        return False

    def reset_parameters(self, generator: torch.Generator | None = None):
        raise NotImplementedError


class Dense(Module):
    """`y = act(W @ x + b)` with x shaped (in_dim, N)."""

    def __init__(self, in_dim: int, out_dim: int,
                 activation: Callable | None = None, *, use_bias: bool = True,
                 init_weight=glorot_uniform, init_bias=zeros_init,
                 dtype=None, device=None):
        super().__init__()
        self._in = in_dim
        self._out = out_dim
        self.activation = activation or identity
        self.init_weight = init_weight
        self.init_bias = init_bias
        dtype = dtype or default_float()
        self.weight = nn.Parameter(
            torch.empty((out_dim, in_dim), dtype=dtype, device=device))
        self.bias = (nn.Parameter(torch.empty((out_dim, 1), dtype=dtype,
                                              device=device))
                     if use_bias else None)
        self.reset_parameters()

    @property
    def in_dim(self):
        return self._in

    @property
    def out_dim(self):
        return self._out

    @property
    def has_taylor_rule(self):
        return self.activation in TAYLOR_RULES

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        w = self.weight
        w.copy_(self.init_weight(generator, tuple(w.shape), w.dtype, w.device))
        if self.bias is not None:
            b = self.bias
            b.copy_(self.init_bias(generator, tuple(b.shape), b.dtype, b.device))

    def _affine(self, x):
        if self.bias is None:
            return self.weight @ x
        return torch.addmm(self.bias, self.weight, x)

    def forward(self, x, series: Sequence[torch.Tensor] | None = None):
        z = self._affine(x)
        if series is None:
            return self.activation(z)
        zs = [self.weight @ xk for xk in series]
        a, a_series = TAYLOR_RULES[self.activation](z, zs)
        return a, tuple(a_series)


class Chain(Module):
    """Sequential container; submodules are named layer_0, layer_1, ..."""

    def __init__(self, *layers: Module):
        super().__init__()
        for i, layer in enumerate(layers):
            self.add_module(f"layer_{i}", layer)

    @property
    def layers(self):
        return tuple(self.children())

    @property
    def in_dim(self):
        return self.layers[0].in_dim

    @property
    def out_dim(self):
        return self.layers[-1].out_dim

    @property
    def has_taylor_rule(self):
        return all(getattr(l, "has_taylor_rule", False) for l in self.layers)

    def reset_parameters(self, generator=None):
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, x, series: Sequence[torch.Tensor] | None = None):
        for layer in self.layers:
            if series is None:
                x = layer(x)
            else:
                x, series = layer(x, series)
        return x if series is None else (x, series)


def mlp(sizes: Sequence[int], activation: Callable = tanh,
        out_activation: Callable | None = None, *, dtype=None,
        device=None) -> Chain:
    """Convenience constructor: mlp([2, 16, 16, 1]) -> 3-layer Chain."""
    layers = []
    for i in range(len(sizes) - 1):
        act = activation if i < len(sizes) - 2 else out_activation
        layers.append(Dense(sizes[i], sizes[i + 1], act, dtype=dtype,
                            device=device))
    return Chain(*layers)


class TrialFunction:
    """A module bound to one parameter dict (the module's own names, e.g.
    ``layer_0.weight``): ``u(x)``, and ``u.taylor(x, series)`` when the
    module has Taylor rules.  Derivative engines take this in place of the
    JAX package's closure, since Taylor mode needs the module itself."""

    def __init__(self, module: nn.Module, params: dict):
        self.module = module
        self.params = params

    @property
    def has_taylor_rule(self) -> bool:
        return getattr(self.module, "has_taylor_rule", False)

    def __call__(self, x):
        return functional_call(self.module, self.params, (x,), strict=True)

    def taylor(self, x, series):
        return functional_call(self.module, self.params, (x, tuple(series)),
                               strict=True)
