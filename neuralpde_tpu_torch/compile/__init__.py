from .discretize import (  # noqa: F401
    BayesianPINN, PhysicsInformedNN, Phi, PINNLossFunctions, PINNRepresentation,
    TrainingProblem, discretize, symbolic_discretize,
)
