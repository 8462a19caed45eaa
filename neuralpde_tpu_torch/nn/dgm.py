"""Deep Galerkin Method architecture (`neuralpde_tpu.nn.dgm`; reference:
src/dgm.jl).

LSTM-style gated layer:
  Z = σ₁(Uz x + Wz S + bz);  G = σ₁(Ug x + Wg S + bg)
  R = σ₁(Ur x + Wr S + br);  H = σ₂(Uh x + Wh (S∘R) + bh)
  S' = (1 - G)∘H + Z∘S
(reference: src/dgm.jl:40-48), chained behind an input Dense and closed by an
output Dense (reference: src/dgm.jl:97-115).

With activations that have Taylor rules the network has one too: the four
affine maps act on every coefficient (bias on the primal only), each gate
goes through its activation's rule (tanh at order 2: the `tanh_jet2`
kernel, four launches a gated layer) and the three products are Leibniz
products of truncated series (`_Series`).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..config import default_float
from .core import (
    TAYLOR_RULES, Dense, Module, _Series, glorot_uniform, identity, tanh,
    zeros_init,
)

_GATES = "zgrh"


class DGMLSTMLayer(Module):
    """(S, x) -> S' gated update; parameters carry the reference's field
    names (reference: src/dgm.jl:17-32): ``U*`` (out, in), ``W*`` (out, out),
    ``b*`` (out, 1)."""

    def __init__(self, in_dims: int, out_dims: int, activation1: Callable,
                 activation2: Callable, *, init_weight=glorot_uniform,
                 init_bias=zeros_init, dtype=None, device=None):
        super().__init__()
        self.in_dims = in_dims
        self.out_dims = out_dims
        self.activation1 = activation1
        self.activation2 = activation2
        self.init_weight = init_weight
        self.init_bias = init_bias
        dtype = dtype or default_float()
        o, i = out_dims, in_dims
        # registration order is the reference's draw order
        for prefix, shape in (("U", (o, i)), ("W", (o, o)), ("b", (o, 1))):
            for g in _GATES:
                self.register_parameter(prefix + g, nn.Parameter(
                    torch.empty(shape, dtype=dtype, device=device)))
        self.reset_parameters()

    @property
    def in_dim(self):
        return self.in_dims

    @property
    def out_dim(self):
        return self.out_dims

    @property
    def has_taylor_rule(self):
        return (self.activation1 in TAYLOR_RULES
                and self.activation2 in TAYLOR_RULES)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for name, p in self.named_parameters():
            init = self.init_bias if name.startswith("b") else self.init_weight
            p.copy_(init(generator, tuple(p.shape), p.dtype, p.device))

    def _pre(self, g: str, x, s):
        """Uᵍ x + Wᵍ s + bᵍ."""
        return torch.addmm(getattr(self, "b" + g), getattr(self, "U" + g),
                           x) + getattr(self, "W" + g) @ s

    def _lin(self, g: str, x, s):
        """The same map on a higher coefficient: no bias."""
        return getattr(self, "U" + g) @ x + getattr(self, "W" + g) @ s

    def forward(self, S, x, S_series=None, x_series=None):
        a1, a2 = self.activation1, self.activation2
        if S_series is None:
            Z, G, R = (a1(self._pre(g, x, S)) for g in "zgr")
            H = a2(self._pre("h", x, S * R))
            return (1.0 - G) * H + Z * S

        def gate(act, g, s, s_series):
            return _Series.of(*TAYLOR_RULES[act](
                self._pre(g, x, s),
                [self._lin(g, xk, sk) for xk, sk in zip(x_series, s_series)]))

        Ss = _Series.of(S, S_series)
        Z, G, R = (gate(a1, g, S, S_series) for g in "zgr")
        SR, SR_series = (Ss * R).result()
        H = gate(a2, "h", SR, SR_series)
        return ((1.0 - G) * H + Z * Ss).result()


class DGM(Module):
    """Full DGM network: x -> Dense -> L gated layers -> Dense
    (reference: src/dgm.jl:97-115).  Parameter names are the reference's:
    ``input.weight``, ``lstm_0.Uz`` ... ``lstm_0.bh``, ``output.weight``."""

    def __init__(self, in_dims: int, out_dims: int, modes: int, layers: int,
                 activation1: Callable = tanh, activation2: Callable = tanh,
                 out_activation: Callable = identity, *, dtype=None,
                 device=None):
        super().__init__()
        self.in_dims = in_dims
        self.out_dims = out_dims
        self.n_layers = layers
        self.add_module("input", Dense(in_dims, modes, activation1,
                                       dtype=dtype, device=device))
        for i in range(layers):
            self.add_module(f"lstm_{i}", DGMLSTMLayer(
                in_dims, modes, activation1, activation2, dtype=dtype,
                device=device))
        self.add_module("output", Dense(modes, out_dims, out_activation,
                                        dtype=dtype, device=device))

    @property
    def input_layer(self):
        return self.get_submodule("input")

    @property
    def lstm_layers(self):
        return [self.get_submodule(f"lstm_{i}") for i in range(self.n_layers)]

    @property
    def output_layer(self):
        return self.get_submodule("output")

    @property
    def in_dim(self):
        return self.in_dims

    @property
    def out_dim(self):
        return self.out_dims

    @property
    def has_taylor_rule(self):
        return all(m.has_taylor_rule for m in self.children())

    def reset_parameters(self, generator=None):
        # the reference's key order: input, the gated layers, output
        for m in self.children():
            m.reset_parameters(generator)

    def forward(self, x, series=None):
        if series is None:
            S = self.input_layer(x)
            for layer in self.lstm_layers:
                S = layer(S, x)
            return self.output_layer(S)
        S, S_series = self.input_layer(x, series)
        for layer in self.lstm_layers:
            S, S_series = layer(S, x, S_series, series)
        return self.output_layer(S, S_series)
