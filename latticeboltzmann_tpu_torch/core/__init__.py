from . import geometry, spec
from .spec import LatticeConfig

__all__ = ["geometry", "spec", "LatticeConfig"]
