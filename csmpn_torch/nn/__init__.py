from .modules import (  # noqa: F401
    CEMLP,
    MVLayerNorm,
    MVLinear,
    MVSiLU,
    NormalizationLayer,
    SteerableGeometricProductLayer,
    init_parameters,
)
from .egcl import EGCL  # noqa: F401
