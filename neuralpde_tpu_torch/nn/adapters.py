"""Network adapter (`neuralpde_tpu.nn.adapters`; FromFluxAdaptor analog).

The reference converts Flux chains to Lux transparently (reference:
src/pinn_types.jl:149-155), and the JAX package wraps Flax and Haiku
modules.  The port's counterpart wraps any `torch.nn.Module` so that an
existing model drops into `PhysicsInformedNN`, `NNODE`, ...

Convention: this package is column-major (``(features, batch)``), while
torch models conventionally take ``(batch, features)``; the adapter
transposes at the boundary.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import default_float
from .core import _Wrapper


class TorchModuleAdapter(_Wrapper):
    """Wrap a `torch.nn.Module` with the (batch, features) convention.

    >>> net = TorchModuleAdapter(
    ...     nn.Sequential(nn.Linear(2, 16), nn.Tanh(), nn.Linear(16, 1)),
    ...     in_dim=2, out_dim=1)

    Parameter names are the wrapped module's own (``"0.weight"``).  Its
    floating-point parameters and buffers are cast to the package's default
    float (torch initializes float32 whatever `enable_x64` says; optimizer
    state and flattening need one dtype).

    The adapter has no Taylor rule, so every derivative engine, ``"jet"``
    too, differentiates it by nested `torch.func.jvp`: the wrapped module
    must work under `torch.func` transforms (no in-place update of a
    buffer in ``forward``, no ``.item()`` or other host read, no
    `torch.autograd.Function` without a ``jvp`` rule) and, on the card, be
    capturable in a CUDA graph.
    """

    def __init__(self, module: nn.Module, in_dim: int, out_dim: int):
        module.to(default_float())
        super().__init__(module)
        self._in = in_dim
        self._out = out_dim

    @property
    def module(self):
        return self._inner

    @property
    def in_dim(self):
        return self._in

    @property
    def out_dim(self):
        return self._out

    @property
    def has_taylor_rule(self):
        return False

    def reset_parameters(self, generator=None):
        """Redraw with the wrapped submodules' own ``reset_parameters``.
        They draw from torch's global generator: it is seeded from
        ``generator`` for the draw and restored afterwards."""
        with torch.random.fork_rng(devices=[]):
            if generator is not None:
                torch.manual_seed(int(torch.randint(
                    0, 2 ** 31 - 1, (1,), generator=generator,
                    device=generator.device)))
            for m in self._inner.modules():
                reset = getattr(m, "reset_parameters", None)
                if callable(reset):
                    reset()

    def forward(self, x):
        return self._inner(x.T).T
