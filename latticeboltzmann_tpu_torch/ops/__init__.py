from . import fused_kernel, stream_collide

__all__ = ["fused_kernel", "stream_collide"]
