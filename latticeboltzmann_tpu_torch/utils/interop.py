"""State and dtype interchange between the JAX package and the port.

Both packages keep the state as speed-major (9, NX, NY) planes and the
geometry as an (NX, NY) bool mask, so crossing over is a numpy round
trip: the JAX package hands out `Simulation.state()` and `walls_np`
(latticeboltzmann_tpu/models/engine.py:485-492), and the port takes
them here. A pair-DP state (the JAX package's df64.DS) crosses as its
two float32 component arrays, bit for bit; a bf16 state crosses as its
uint16 bits. Nothing in this module imports jax or ml_dtypes.

bfloat16 without numpy bf16: numpy has no bfloat16 of its own, and
`np.dtype("bfloat16")` works only once ml_dtypes is imported (JAX
imports it). The port runs where neither is installed, so it never asks
numpy for a bf16 dtype: `storage_dtype` names bf16 by torch.bfloat16,
and on the host a bf16 state is a float32 array holding the exact
upcast of each value.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import NSPEEDS, LatticeConfig
from ..ops.df64 import DS

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_STORAGE_TORCH = (torch.float32, torch.float64, torch.bfloat16)


def storage_dtype(dtype) -> torch.dtype:
    """The torch storage dtype of a LatticeConfig dtype: float32,
    float64, or bfloat16. bfloat16 is accepted as the string
    "bfloat16", torch.bfloat16, or any type or dtype named "bfloat16"
    (the ml_dtypes type a JAX config carries), without importing
    ml_dtypes. Anything else (float16, integers, ...) raises
    NotImplementedError."""
    if isinstance(dtype, torch.dtype):
        if dtype in _STORAGE_TORCH:
            return dtype
    elif (
        (isinstance(dtype, str) and dtype == "bfloat16")
        or getattr(dtype, "__name__", None) == "bfloat16"
        or (isinstance(dtype, np.dtype) and dtype.name == "bfloat16")
    ):
        return torch.bfloat16
    else:
        try:
            return _TORCH_DTYPES[np.dtype(dtype)]
        except (KeyError, TypeError):
            pass
    raise NotImplementedError(
        f"dtype {dtype!r} is not supported by the port (float32, float64 and "
        "bfloat16 storage are)"
    )


# the name earlier callers use; same function
torch_dtype = storage_dtype


def compute_dtype(dtype) -> torch.dtype:
    """The arithmetic dtype for a storage dtype: float32 for bf16
    storage (the JAX package's mixed-precision contract,
    latticeboltzmann_tpu/ops/stream_collide.py:25-33), else itself."""
    st = storage_dtype(dtype)
    return torch.float32 if st == torch.bfloat16 else st


def bytes_per_site(dtype) -> int:
    """Device-memory bytes of one site update: 9 reads + 9 writes of the
    storage type (core/spec.py::bytes_per_site_update, which needs a
    numpy dtype, for any storage dtype)."""
    return 2 * NSPEEDS * storage_dtype(dtype).itemsize


def round_bf16(x) -> np.ndarray:
    """float32 values rounded to the nearest bf16 (ties to even), as a
    float32 array (the exact upcast)."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).float().numpy()


def from_bf16_bits(u16, device: str | torch.device) -> torch.Tensor:
    """A bfloat16 tensor on `device` whose bits are the uint16 array
    u16 (e.g. `np.asarray(jax_bf16_array).view(np.uint16)`), bit for
    bit."""
    u16 = np.ascontiguousarray(u16)
    if u16.dtype != np.uint16:
        raise ValueError(f"bf16 bits are a uint16 array, got {u16.dtype}")
    return torch.from_numpy(u16.view(np.int16).copy()).view(torch.bfloat16).to(device)


def to_bf16_bits(t: torch.Tensor) -> np.ndarray:
    """The uint16 bits of a bfloat16 tensor, as a host array (the JAX
    package takes them with `.view(jnp.bfloat16)`)."""
    if t.dtype != torch.bfloat16:
        raise ValueError(f"expected a bfloat16 tensor, got {t.dtype}")
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(np.uint16)


def state_tensor(f_np, dtype, device: str | torch.device) -> torch.Tensor:
    """A state tensor of the storage dtype on `device`, copied from a
    host array. For bf16 storage the array may be a bf16 (ml_dtypes)
    array, taken bit for bit, or any float array, rounded to nearest
    even; other dtypes convert as numpy does."""
    st = storage_dtype(dtype)
    f_np = np.asarray(f_np)
    if st != torch.bfloat16:
        return torch.tensor(f_np, dtype=st, device=device)
    if f_np.dtype.name == "bfloat16":
        return from_bf16_bits(f_np.view(np.uint16), device)
    return torch.from_numpy(np.ascontiguousarray(f_np, dtype=np.float32)).to(
        device=device, dtype=torch.bfloat16)


def from_numpy_state(
    f_np: np.ndarray,
    walls_np: np.ndarray,
    cfg_fields: dict,
    device: str | torch.device,
) -> tuple[torch.Tensor, torch.Tensor, LatticeConfig]:
    """(f, walls, cfg) on `device` from the JAX package's numpy state,
    wall mask and config fields (`dataclasses.asdict(cfg)`; an unknown
    field raises TypeError). f keeps the config's storage dtype (a bf16
    state is taken bit for bit); walls are a bool (NX, NY) tensor."""
    cfg = LatticeConfig(**cfg_fields)
    f_np = np.asarray(f_np)
    walls_np = np.asarray(walls_np, dtype=bool)
    if f_np.shape != (9, cfg.nx, cfg.ny):
        raise ValueError(f"state shape {f_np.shape} != (9, {cfg.nx}, {cfg.ny})")
    if walls_np.shape != (cfg.nx, cfg.ny):
        raise ValueError(f"walls shape {walls_np.shape} != ({cfg.nx}, {cfg.ny})")
    # state_tensor copies: jax hands out read-only arrays
    f = state_tensor(f_np, cfg.dtype, device)
    walls = torch.tensor(walls_np, device=device)
    return f, walls, cfg


def to_numpy(f: torch.Tensor) -> np.ndarray:
    """A host numpy copy of a port tensor (any device). A bfloat16
    tensor comes back as float32, the exact upcast: numpy has no bf16
    where ml_dtypes is not installed."""
    f = f.detach()
    if f.dtype == torch.bfloat16:
        f = f.float()
    return f.cpu().numpy()


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
