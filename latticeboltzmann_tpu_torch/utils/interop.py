"""State and dtype interchange between the JAX package and the port.

Both packages keep the state as speed-major (9, NX, NY) planes and the
geometry as an (NX, NY) bool mask, so crossing over is a numpy round
trip: the JAX package hands out `Simulation.state()` and `walls_np`
(latticeboltzmann_tpu/models/engine.py:485-492), and the port takes
them here. Nothing in this module imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import LatticeConfig

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a LatticeConfig dtype (float32 or float64;
    bf16 storage is ROADMAP B3)."""
    try:
        return _TORCH_DTYPES[np.dtype(dtype)]
    except (KeyError, TypeError):
        raise NotImplementedError(
            f"dtype {dtype!r} is not supported by the port yet (float32 and "
            "float64 are; bf16 storage is ROADMAP B3)"
        ) from None


def from_numpy_state(
    f_np: np.ndarray,
    walls_np: np.ndarray,
    cfg_fields: dict,
    device: str | torch.device,
) -> tuple[torch.Tensor, torch.Tensor, LatticeConfig]:
    """(f, walls, cfg) on `device` from the JAX package's numpy state,
    wall mask and config fields (`dataclasses.asdict(cfg)`; an unknown
    field raises TypeError). f keeps the config's dtype; walls are a
    bool (NX, NY) tensor."""
    cfg = LatticeConfig(**cfg_fields)
    f_np = np.asarray(f_np)
    walls_np = np.asarray(walls_np, dtype=bool)
    if f_np.shape != (9, cfg.nx, cfg.ny):
        raise ValueError(f"state shape {f_np.shape} != (9, {cfg.nx}, {cfg.ny})")
    if walls_np.shape != (cfg.nx, cfg.ny):
        raise ValueError(f"walls shape {walls_np.shape} != ({cfg.nx}, {cfg.ny})")
    # torch.tensor copies: jax hands out read-only arrays
    f = torch.tensor(f_np, dtype=torch_dtype(cfg.dtype), device=device)
    walls = torch.tensor(walls_np, device=device)
    return f, walls, cfg


def to_numpy(f: torch.Tensor) -> np.ndarray:
    """A host numpy copy of a port tensor (any device)."""
    return f.detach().cpu().numpy()
