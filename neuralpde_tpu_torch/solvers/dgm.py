"""DeepGalerkin sugar (reference: src/dgm.jl:143-152):
`DeepGalerkin(...) = PhysicsInformedNN(DGM(...), strategy)`."""

from __future__ import annotations

from typing import Callable

from ..compile.discretize import PhysicsInformedNN
from ..nn.dgm import DGM
from ..strategies import TrainingStrategy


def DeepGalerkin(in_dims: int, out_dims: int, modes: int, L: int,
                 activation1: Callable, activation2: Callable,
                 out_activation: Callable, strategy: TrainingStrategy,
                 **kwargs) -> PhysicsInformedNN:
    return PhysicsInformedNN(
        DGM(in_dims, out_dims, modes, L, activation1, activation2,
            out_activation),
        strategy, **kwargs)
