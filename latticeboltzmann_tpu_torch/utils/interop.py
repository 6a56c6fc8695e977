"""State and dtype interchange between the JAX package and the port.

Both packages keep the state as speed-major (9, NX, NY) planes and the
geometry as an (NX, NY) bool mask, so crossing over is a numpy round
trip: the JAX package hands out `Simulation.state()` and `walls_np`
(latticeboltzmann_tpu/models/engine.py:485-492), and the port takes
them here. A pair-DP state (the JAX package's df64.DS) crosses as its
two float32 component arrays, bit for bit. Nothing in this module
imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import LatticeConfig
from ..ops.df64 import DS

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


def from_ds_pair(hi_np: np.ndarray, lo_np: np.ndarray, device: str | torch.device) -> DS:
    """A port DS pair on `device` from the two float32 component arrays
    of a JAX df64.DS (np.asarray(f.hi), np.asarray(f.lo)), copied bit
    for bit."""
    hi_np, lo_np = np.asarray(hi_np), np.asarray(lo_np)
    if hi_np.dtype != np.float32 or lo_np.dtype != np.float32 or hi_np.shape != lo_np.shape:
        raise ValueError(
            f"a ds pair is two same-shape float32 arrays, got {hi_np.dtype}{hi_np.shape} "
            f"and {lo_np.dtype}{lo_np.shape}"
        )
    return DS(torch.tensor(hi_np, device=device), torch.tensor(lo_np, device=device))


def to_ds_pair(f: DS) -> tuple[np.ndarray, np.ndarray]:
    """The two float32 host arrays (hi, lo) of a port DS pair, which
    the JAX package's df64.DS takes as they are."""
    return to_numpy(f.hi), to_numpy(f.lo)
