from . import golden
from .engine import Simulation, available_backends, initial_state, register_backend

__all__ = ["golden", "Simulation", "available_backends", "initial_state", "register_backend"]
