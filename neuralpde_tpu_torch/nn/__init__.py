from .core import (  # noqa: F401
    Chain, Dense, FourierFeatures, Module, PeriodicEmbedding, SkipConnection,
    Transformed, TrialFunction, gelu, glorot_normal, glorot_uniform, identity,
    mlp, relu, sigmoid, sin, softplus, swish, tanh, zeros_init,
)
from .separable import SeparableNet, separable_mlp  # noqa: F401
from .kan import KANLayer, kan  # noqa: F401
from .dgm import DGM, DGMLSTMLayer  # noqa: F401
from .fbpinn import FBPINN  # noqa: F401
from .adapters import TorchModuleAdapter  # noqa: F401
from .deeponet import DeepONet, DeepONetPDE  # noqa: F401
from .fno import (  # noqa: F401
    FNO1D, FNO2D, FNO3D, SpectralConv1D, SpectralConv2D, SpectralConv3D,
)
