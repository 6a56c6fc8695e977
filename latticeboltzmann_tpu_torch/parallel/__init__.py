from . import sharded

__all__ = ["sharded"]
