from .engine import Simulation, available_backends, initial_state, register_backend

__all__ = ["Simulation", "available_backends", "initial_state", "register_backend"]
