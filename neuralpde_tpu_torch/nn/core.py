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
The embeddings (`FourierFeatures`, `PeriodicEmbedding`) are linear maps into
sin/cos, and the wrappers around user functions (`Transformed`,
`SkipConnection`) push the inner series through the user's function by
truncated-Taylor arithmetic (`_Series`).

``forward(x, Directions(...))`` carries one series per direction over one
primal, for modules with `has_directions_rule`: a Dense layer makes its
primal product once and one product per series tensor of each direction,
and each activation's rule takes the one pre-activation with each
direction's series.  A derivative engine takes the pure partials of one
call along several coordinates from one such pass.

`Transformed` and `SkipConnection` add no level to parameter names, as
their JAX counterparts return ``base.init(key)``: they share the wrapped
module's registries (see `_Wrapper`).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import nn
from torch.func import functional_call, jvp
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..config import default_float
from ..kernels.tanh_jet import tanh_jet2
from ..parallel.mesh import (
    CopyToModel, GatherFromModel, ReduceFromModel, model_group,
)


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


def _sin_cos_series(z, zs):
    """(sin z, its series, cos z, its series) from one recurrence."""
    zt = _normalise(zs)
    s, c = [torch.sin(z)], [torch.cos(z)]                  # s' = c z', c' = -s z'
    for k in range(1, len(zs) + 1):
        s.append(_ode_step(zt, c, k))
        c.append(-_ode_step(zt, s, k))
    return s[0], _denormalise(s), c[0], _denormalise(c)


def _sin_series(z, zs):
    s, s_series, _, _ = _sin_cos_series(z, zs)
    return s, s_series


def _identity_series(z, zs):
    return z, list(zs)


def _product_coeffs(a, b):
    """Normalised coefficients of the product of two series (a[0], b[0]
    their primals)."""
    return [sum(a[i] * b[m - i] for i in range(m + 1)) for m in range(len(a))]


def _relu_series(z, zs):
    """relu' = 1 on z > 0 and 0 elsewhere (at 0 too, as JAX's and torch's
    derivatives of relu), and every higher derivative is 0."""
    mask = (z > 0).to(z.dtype)
    return torch.relu(z), [mask * zk for zk in zs]


def _softplus_series(z, zs):
    """softplus' = sigmoid: a' = sigmoid(z) z'."""
    zt = _normalise(zs)
    s0, s_series = _sigmoid_series(z, zs[:-1])
    g = [s0] + _normalise(s_series)
    a = [softplus(z)] + [_ode_step(zt, g, k) for k in range(1, len(zs) + 1)]
    return a[0], _denormalise(a)


def _swish_series(z, zs):
    """swish = z sigmoid(z): the product of two series."""
    s0, s_series = _sigmoid_series(z, zs)
    a = _product_coeffs([z] + _normalise(zs), [s0] + _normalise(s_series))
    return swish(z), _denormalise(a)


_GELU_C = math.sqrt(2.0 / math.pi)


def _gelu_series(z, zs):
    """gelu (tanh form) = z (1 + tanh(c (z + 0.044715 z^3))) / 2."""
    cz = [z] + _normalise(zs)
    cz3 = _product_coeffs(_product_coeffs(cz, cz), cz)
    cu = [_GELU_C * (a + 0.044715 * b) for a, b in zip(cz, cz3)]
    t0, t_series = _tanh_series(cu[0], _denormalise(cu))
    zt = _product_coeffs(cz, [t0] + _normalise(t_series))
    a = [0.5 * (x + y) for x, y in zip(cz, zt)]
    return gelu(z), _denormalise(a)


class Directions(tuple):
    """Taylor series along several directions over one primal: one series
    (a tuple of tensors, derivative convention) per direction.  A module
    with `has_directions_rule` takes it in place of a single series in
    ``forward(x, series)`` and returns its output's series as `Directions`
    in the same order."""


def _map_series(series, fn):
    """``fn`` on every tensor of one series (a tuple) or of `Directions`."""
    if isinstance(series, Directions):
        return Directions(tuple(fn(s) for s in d) for d in series)
    return tuple(fn(s) for s in series)


def _per_direction(series, one):
    """``one(series) -> (primal, series)`` on one series, or on each
    direction's series of `Directions`: the first direction's primal is
    the result's (every direction computes the same one)."""
    if not isinstance(series, Directions):
        primal, out = one(series)
        return primal, tuple(out)
    outs = [one(d) for d in series]
    return outs[0][0], Directions(tuple(s) for _, s in outs)


TAYLOR_RULES: dict[Callable, Callable] = {
    tanh: _tanh_series,
    sigmoid: _sigmoid_series,
    sin: _sin_series,
    identity: _identity_series,
    relu: _relu_series,
    gelu: _gelu_series,
    swish: _swish_series,
    softplus: _softplus_series,
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

    @property
    def has_directions_rule(self) -> bool:
        """Whether ``forward(x, series)`` also takes `Directions`."""
        return False

    def reset_parameters(self, generator: torch.Generator | None = None):
        raise NotImplementedError

    def prepare(self, dtype, device) -> None:
        """Make the constant tensors that ``forward`` reads beside its
        parameters (an `FBPINN`'s subdomain geometry) for ``dtype`` on
        ``device``.  `symbolic_discretize` calls it when a problem is
        built, so that no step creates them under a `torch.func` transform
        or a CUDA-graph capture.  Containers pass it on."""
        for child in self.children():
            if isinstance(child, Module):
                child.prepare(dtype, device)


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

    @property
    def has_directions_rule(self):
        return self.has_taylor_rule

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

    @property
    def column_parallel(self) -> bool:
        """The weight holds this rank's output rows (`shard_params_tp`)."""
        return self.weight.shape[0] != self._out

    @property
    def row_parallel(self) -> bool:
        """The weight holds this rank's input columns."""
        return self.weight.shape[1] != self._in

    def forward(self, x, series: Sequence[torch.Tensor] | None = None):
        if self.column_parallel or self.row_parallel:
            z, zs = self._tensor_parallel(x, series)
            products = list
        else:
            z, zs = self._affine(x), series
            products = lambda d: [self.weight @ xk for xk in d]  # noqa: E731
        if series is None:
            return self.activation(z)
        rule = TAYLOR_RULES[self.activation]
        # a direction's products are made just before its rule reads them,
        # while they are still in the card's L2 cache
        return _per_direction(zs, lambda d: rule(z, products(d)))

    def _tensor_parallel(self, x, series):
        """The affine map and its series on tensor-parallel parameters
        (`parallel.mesh.shard_params_tp`).  Column-parallel: this rank's
        output rows, with no collective (the cotangents of the input are
        summed over the model axis).  Row-parallel: the rank's partial
        products over its input columns, summed over the model axis, then
        the bias, once.  The activation that follows is elementwise, so
        it (and `tanh_jet2`) runs on the local rows unchanged."""
        group = model_group()
        if group is None:
            raise ValueError(
                f"Dense({self._in}, {self._out}) got a weight of shape "
                f"{tuple(self.weight.shape)}: tensor-parallel parameters "
                "need an active mesh with a model axis")
        directions = isinstance(series, Directions)
        ins = [x] + ([s for d in series for s in d] if directions
                     else list(series or ()))
        if self.column_parallel:
            ins = [CopyToModel.apply(v, group) if v.requires_grad else v
                   for v in ins]
            z = self._affine(ins[0])
            outs = [self.weight @ v for v in ins[1:]]
        else:
            parts = ReduceFromModel.apply(
                torch.stack([self.weight @ v for v in ins]), group)
            z = parts[0] if self.bias is None else parts[0] + self.bias
            outs = list(parts[1:])
        if directions:
            it = iter(outs)
            return z, Directions(tuple(next(it) for _ in d) for d in series)
        return z, outs


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

    @property
    def has_directions_rule(self):
        return all(getattr(l, "has_directions_rule", False)
                   for l in self.layers)

    def reset_parameters(self, generator=None):
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, x, series: Sequence[torch.Tensor] | None = None):
        layers = self.layers
        group = model_group()
        for i, layer in enumerate(layers):
            if series is None:
                x = layer(x)
            else:
                x, series = layer(x, series)
            if group is not None and _split_output(layer, layers[i + 1:]):
                # a column-parallel output that no row-parallel layer takes
                x = GatherFromModel.apply(x, group)
                if series is not None:
                    series = _map_series(
                        series, lambda v: GatherFromModel.apply(v, group))
        return x if series is None else (x, series)


def _split_output(layer, rest) -> bool:
    """Whether ``layer`` leaves this rank's rows only and the next layer is
    not a row-parallel `Dense` that takes them."""
    if not (isinstance(layer, Dense) and layer.column_parallel):
        return False
    return not (rest and isinstance(rest[0], Dense) and rest[0].row_parallel)


def mlp(sizes: Sequence[int], activation: Callable = tanh,
        out_activation: Callable | None = None, *,
        fourier_features: int | None = None, fourier_sigma: float = 1.0,
        dtype=None, device=None) -> Chain:
    """Convenience constructor: mlp([2, 16, 16, 1]) -> 3-layer Chain.

    ``fourier_features=m`` prepends a fixed random Fourier embedding with m
    frequencies (bandwidth ``fourier_sigma``); the first Dense layer then
    takes the 2m embedded channels instead of the raw coordinates.
    """
    layers = []
    start = 0
    if fourier_features:
        layers.append(FourierFeatures(sizes[0], fourier_features,
                                      fourier_sigma, dtype=dtype,
                                      device=device))
        layers.append(Dense(2 * fourier_features, sizes[1],
                            activation if len(sizes) > 2 else out_activation,
                            dtype=dtype, device=device))
        start = 1
    for i in range(start, len(sizes) - 1):
        act = activation if i < len(sizes) - 2 else out_activation
        layers.append(Dense(sizes[i], sizes[i + 1], act, dtype=dtype,
                            device=device))
    return Chain(*layers)


def _lift_series(fn: Callable, primals, series_list):
    """Taylor series (derivative convention) of ``fn`` applied to series
    inputs: the derivatives at t = 0 of ``g(t) = fn(*(p + sum_k s_k t^k /
    k!))``, by K nested `torch.func.jvp` in the scalar t.  Exact to order
    K, since those derivatives depend only on the first K coefficients."""
    order = len(series_list[0])
    like = primals[0]
    one = torch.ones((), dtype=like.dtype, device=like.device)
    scaled = [[s_k / math.factorial(k) for k, s_k in enumerate(series, 1)]
              for series in series_list]

    def path(t):
        def horner(p, cs):
            acc = cs[-1]
            for c in reversed(cs[:-1]):
                acc = c + t * acc
            return p + t * acc

        return fn(*(horner(p, cs) for p, cs in zip(primals, scaled)))

    def derivatives(k):
        """t -> (g(t), g'(t), ..., g^(k)(t))."""
        if k == 0:
            return lambda t: (path(t),)
        inner = derivatives(k - 1)

        def outer(t):
            values, tangents = jvp(inner, (t,), (one,))
            return (*values, tangents[-1])

        return outer

    out = derivatives(order)(torch.zeros_like(one))
    return out[0], out[1:]


class _Series:
    """A truncated Taylor series under the arithmetic of user functions:
    how `Transformed` and `SkipConnection` push series through their
    lambdas.  Coefficients are normalised (c_k = z_k / k!; None is a zero
    coefficient); +, -, *, /, integer powers and indexing combine them in
    plain tensor ops, and any other torch function is lifted by nested jvp
    (`_lift_series`).  A wrapped jet stays one level of forward mode under
    an outer `torch.func` transform, where nested jvps would not."""

    __slots__ = ("c",)

    def __init__(self, coeffs):
        self.c = list(coeffs)

    @classmethod
    def of(cls, primal, series):
        return cls([primal] + [s / math.factorial(k)
                               for k, s in enumerate(series, 1)])

    def result(self):
        """(primal, derivative-convention series)."""
        zero = torch.zeros_like(self.c[0])
        return self.c[0], tuple(zero if c is None else c * math.factorial(k)
                                for k, c in enumerate(self.c[1:], 1))

    def _other(self, o):
        return o.c if isinstance(o, _Series) else [o] + [None] * (
            len(self.c) - 1)

    def __add__(self, o):
        return _Series(a if b is None else b if a is None else a + b
                       for a, b in zip(self.c, self._other(o)))

    __radd__ = __add__

    def __neg__(self):
        return _Series(None if a is None else -a for a in self.c)

    def __sub__(self, o):
        return self + (-o if isinstance(o, _Series) else -o)

    def __rsub__(self, o):
        return -self + o

    def __mul__(self, o):
        a, b = self.c, self._other(o)
        out = []
        for k in range(len(a)):
            terms = [a[i] * b[k - i] for i in range(k + 1)
                     if a[i] is not None and b[k - i] is not None]
            out.append(sum(terms[1:], terms[0]) if terms else None)
        return _Series(out)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if not isinstance(o, _Series):
            return _Series(None if a is None else a / o for a in self.c)
        b, q = o.c, []
        for k, a_k in enumerate(self.c):       # a = q b, solved for q_k
            acc = a_k if a_k is not None else torch.zeros_like(self.c[0])
            for j in range(1, k + 1):
                if b[j] is not None and q[k - j] is not None:
                    acc = acc - b[j] * q[k - j]
            q.append(acc / b[0])
        return _Series(q)

    def __rtruediv__(self, o):
        return _Series([o] + [None] * (len(self.c) - 1)) / self

    def __pow__(self, n):
        if isinstance(n, int) and n >= 0:
            out = _Series([torch.ones_like(self.c[0])]
                          + [None] * (len(self.c) - 1))
            for _ in range(n):
                out = out * self
            return out
        return torch.pow(self, n)

    def __getitem__(self, index):
        return _Series(None if a is None else a[index] for a in self.c)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        leaves, spec = tree_flatten((args, kwargs or {}))
        at = [i for i, leaf in enumerate(leaves) if isinstance(leaf, _Series)]
        primals = [leaves[i].c[0] for i in at]
        series_list = [list(leaves[i].result()[1]) for i in at]

        def fn(*values):
            filled = list(leaves)
            for i, v in zip(at, values):
                filled[i] = v
            a, k = tree_unflatten(filled, spec)
            return func(*a, **k)

        return _Series.of(*_lift_series(fn, primals, series_list))


def _through(fn, *inputs):
    """Taylor series of ``fn`` at series ``inputs`` (primal, series); with
    `Directions`, each direction's series through ``fn`` in turn."""
    if isinstance(inputs[0][1], Directions):
        outs = [_through(fn, *((p, s[i]) for p, s in inputs))
                for i in range(len(inputs[0][1]))]
        return outs[0][0], Directions(s for _, s in outs)
    out = fn(*(_Series.of(p, s) for p, s in inputs))
    if isinstance(out, _Series):
        return out.result()
    return out, tuple(torch.zeros_like(out) for _ in inputs[0][1])


class _Wrapper(Module):
    """A module around ``inner`` that shares its parameter, buffer and
    submodule registries instead of holding it as a child: parameter names
    are ``inner``'s own (no ``inner.`` level, as the JAX package's
    ``init`` returns ``inner.init(key)``), and `functional_call` on the
    wrapper swaps the tensors ``inner`` reads."""

    def __init__(self, inner: Module):
        super().__init__()
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_parameters", inner._parameters)
        object.__setattr__(self, "_buffers", inner._buffers)
        object.__setattr__(self, "_modules", inner._modules)

    @property
    def in_dim(self):
        return self._inner.in_dim

    @property
    def out_dim(self):
        return self._inner.out_dim

    @property
    def has_taylor_rule(self):
        return getattr(self._inner, "has_taylor_rule", False)

    @property
    def has_directions_rule(self):
        return getattr(self._inner, "has_directions_rule", False)

    def reset_parameters(self, generator=None):
        self._inner.reset_parameters(generator)

    def prepare(self, dtype, device):
        if isinstance(self._inner, Module):
            self._inner.prepare(dtype, device)


class SkipConnection(_Wrapper):
    """`y = merge(layer(x), x)` (the DGM block chaining)."""

    def __init__(self, layer: Module, merge: Callable):
        super().__init__(layer)
        self.merge = merge

    @property
    def layer(self):
        return self._inner

    def forward(self, x, series=None):
        if series is None:
            return self.merge(self._inner(x), x)
        out, out_series = self._inner(x, series)
        return _through(self.merge, (out, out_series), (x, series))


class Transformed(_Wrapper):
    """Hard-constraint trial function: ``u(x) = transform(x, base(x))``,
    e.g. ``lambda c, o: c * (1 - c) * o`` for a zero boundary on [0, 1].
    Derivatives are exact under every engine; under Taylor mode the base
    net keeps its own rules (and the `tanh_jet2` kernel)."""

    def __init__(self, base: Module, transform: Callable):
        super().__init__(base)
        self.transform = transform

    @property
    def base(self):
        return self._inner

    def forward(self, x, series=None):
        if series is None:
            return self.transform(x, self._inner(x))
        out, out_series = self._inner(x, series)
        return _through(self.transform, (x, series), (out, out_series))


class FourierFeatures(Module):
    """Random Fourier feature embedding ``[sin(2 pi B x); cos(2 pi B x)]``
    with ``B ~ N(0, sigma^2)`` of shape ``(n_frequencies, in_dim)``, drawn at
    init and held fixed: ``B`` rides the parameter dict but is detached in
    `forward` (the JAX package's `stop_gradient`)."""

    def __init__(self, in_dim: int, n_frequencies: int, sigma: float = 1.0,
                 *, dtype=None, device=None):
        super().__init__()
        self._in = in_dim
        self.n_frequencies = n_frequencies
        self.sigma = sigma
        self.B = nn.Parameter(torch.empty((n_frequencies, in_dim),
                                          dtype=dtype or default_float(),
                                          device=device))
        self.reset_parameters()

    @property
    def in_dim(self):
        return self._in

    @property
    def out_dim(self):
        return 2 * self.n_frequencies

    @property
    def has_taylor_rule(self):
        return True

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        b = self.B
        b.copy_(self.sigma * torch.randn(tuple(b.shape), generator=generator,
                                         dtype=b.dtype, device=b.device))

    @property
    def has_directions_rule(self):
        return True

    def forward(self, x, series=None):
        b = self.B.detach()
        proj = 2.0 * math.pi * (b @ x)
        if series is None:
            return torch.cat([torch.sin(proj), torch.cos(proj)], dim=0)

        def one(d):
            s, s_series, c, c_series = _sin_cos_series(
                proj, [2.0 * math.pi * (b @ xk) for xk in d])
            return (torch.cat([s, c], dim=0),
                    tuple(torch.cat([a, b], dim=0)
                          for a, b in zip(s_series, c_series)))

        return _per_direction(series, one)


class PeriodicEmbedding(Module):
    """Exact periodic embedding of one coordinate axis: row ``axis`` is
    replaced by ``sin(2 pi k x / period), cos(2 pi k x / period)``,
    k = 1..n_modes, after the other rows.  No parameters."""

    def __init__(self, in_dim: int, axis: int, period: float, n_modes: int):
        super().__init__()
        self._in = in_dim
        self.axis = axis
        self.period = period
        self.n_modes = n_modes

    @property
    def in_dim(self):
        return self._in

    @property
    def out_dim(self):
        return self._in - 1 + 2 * self.n_modes

    @property
    def has_taylor_rule(self):
        return True

    def reset_parameters(self, generator=None):
        del generator

    def _angles(self, x):
        ks = torch.arange(1, self.n_modes + 1, dtype=x.dtype,
                          device=x.device)[:, None]
        return 2.0 * math.pi / self.period * ks * x[self.axis:self.axis + 1]

    def _rest(self, x):
        return [x[i:i + 1] for i in range(self._in) if i != self.axis]

    @property
    def has_directions_rule(self):
        return True

    def forward(self, x, series=None):
        ang = self._angles(x)
        if series is None:
            return torch.cat(self._rest(x) + [torch.sin(ang), torch.cos(ang)],
                             dim=0)

        def one(d):
            s, s_series, c, c_series = _sin_cos_series(
                ang, [self._angles(xk) for xk in d])
            return (torch.cat(self._rest(x) + [s, c], dim=0),
                    tuple(torch.cat(self._rest(xk) + [a, b], dim=0)
                          for xk, a, b in zip(d, s_series, c_series)))

        return _per_direction(series, one)


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

    @property
    def has_directions_rule(self) -> bool:
        return getattr(self.module, "has_directions_rule", False)

    def __call__(self, x):
        return functional_call(self.module, self.params, (x,), strict=True)

    def taylor(self, x, series):
        return functional_call(self.module, self.params, (x, tuple(series)),
                               strict=True)

    def taylor_directions(self, x, directions):
        """``(primal, [output series of each direction])`` from one pass:
        ``directions`` holds one input series per direction (`Directions`),
        and the module computes the primal once."""
        primal, out = functional_call(
            self.module, self.params,
            (x, Directions(tuple(d) for d in directions)), strict=True)
        return primal, list(out)
