from . import derivatives, quadrature, sampling  # noqa: F401
