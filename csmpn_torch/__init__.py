"""csmpn_torch — Clifford Group Equivariant Simplicial Message Passing
Networks in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``csmpn_tpu`` (the JAX reference package).  Module names mirror
the reference so every counterpart is easy to find.  Entry points run on
the CUDA device unless the caller asks for the CPU (``--device=cpu``); the
CUDA kernels under ``csrc/`` are compiled at first CUDA use.
"""

__version__ = "0.1.0"

from .algebra.clifford import CliffordAlgebra, get_algebra  # noqa: F401
