from .pytree import parameters_to_vector, tree_size, vector_to_parameters  # noqa: F401
from .eltype import EltypeAdaptor, recursive_eltype  # noqa: F401
