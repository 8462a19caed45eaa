from .expr import *  # noqa: F401,F403
from .system import Domain, Interval, PDESystem, in_domain, infimum, supremum  # noqa: F401
