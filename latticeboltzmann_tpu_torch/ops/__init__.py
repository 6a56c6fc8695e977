from . import df64, ds_engine, fused_ds_kernel, fused_kernel, stream_collide

__all__ = ["df64", "ds_engine", "fused_ds_kernel", "fused_kernel", "stream_collide"]
