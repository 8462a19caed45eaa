from .ensemble import EnsembleResult, solve_ensemble  # noqa: F401
