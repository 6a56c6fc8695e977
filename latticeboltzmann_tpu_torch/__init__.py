"""latticeboltzmann_tpu_torch: the D2Q9 lattice-Boltzmann (BGK) framework
of latticeboltzmann_tpu, ported to PyTorch with hand-written CUDA
kernels for Hopper.

The JAX package beside it is the reference: this package keeps its
layout and names, imports torch and numpy, and never jax.
"""

from .core.spec import LatticeConfig, E, W, OPPOSITE, NSPEEDS, FLOP_PER_SITE
from .core import geometry
from .models.engine import Simulation, available_backends, initial_state

__version__ = "0.1.0"

__all__ = [
    "LatticeConfig",
    "Simulation",
    "geometry",
    "available_backends",
    "initial_state",
    "E",
    "W",
    "OPPOSITE",
    "NSPEEDS",
    "FLOP_PER_SITE",
    "__version__",
]
