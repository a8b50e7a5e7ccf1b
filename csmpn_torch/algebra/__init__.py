from .blades import BladeOrder, blade_product, cayley_table  # noqa: F401
from .clifford import CliffordAlgebra, get_algebra  # noqa: F401
