"""Checkpoint / resume: the raw format of
latticeboltzmann_tpu/utils/checkpoint.py, file for file.

A checkpoint is <dir>/<step>.lbmckpt/ holding meta.json (the step, the
config and the state's shape), f.raw (the (9, NX, NY) state in its
storage dtype) and walls.raw (the (NX, NY) mask as uint8), written and
read through utils/native.py. The state is Markov, so a resumed run
continues bit for bit. Either package reads the other's checkpoints.

bf16: f.raw holds the bf16 bits as uint16 and meta.json says
"bfloat16", as the JAX package writes it. The port reads it without
numpy bf16 (no ml_dtypes): load() returns the state as float32 holding
the exact bf16 values, and a bf16 config's dtype is the string
"bfloat16", the port's name for it. The pair-DP backends save
Simulation.state() in float64 with a float64 config, as the JAX CLI
does. A row-sharded run saves the state gathered to one device
(Simulation.state()).

The JAX package's orbax format is not ported (orbax is a JAX library):
format="orbax", and loading a <step>.orbax/ directory, raise
NotImplementedError.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from ..core.spec import LatticeConfig
from . import native
from .interop import from_bf16_bits, state_tensor, storage_dtype, to_bf16_bits, to_numpy

_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.bfloat16: "bfloat16"}
_CFG_DTYPES = {"float32": np.float32, "float64": np.float64, "bfloat16": "bfloat16"}
# what f.raw holds for each meta dtype
_RAW_DTYPES = {"float32": np.float32, "float64": np.float64, "bfloat16": np.uint16}
_ORBAX = ("the orbax checkpoint format is JAX-only and not ported (ROADMAP A6); "
          "use format='raw'")


def dtype_name(dtype) -> str:
    """The meta.json name of a LatticeConfig dtype: float32, float64 or
    bfloat16 (no numpy bf16 needed)."""
    return _NAMES[storage_dtype(dtype)]


def _meta(step: int, f_shape, cfg: LatticeConfig) -> dict:
    return {
        "step": step,
        "nx": cfg.nx,
        "ny": cfg.ny,
        "tau": cfg.tau,
        "csq": cfg.csq,
        "accel": cfg.accel,
        "initial_density": cfg.initial_density,
        "dtype": dtype_name(cfg.dtype),
        "f_shape": list(f_shape),
    }


def _cfg_from_meta(meta: dict) -> LatticeConfig:
    return LatticeConfig(
        nx=meta["nx"],
        ny=meta["ny"],
        tau=meta["tau"],
        csq=meta["csq"],
        accel=meta["accel"],
        initial_density=meta["initial_density"],
        dtype=_CFG_DTYPES[meta["dtype"]],
    )


def _payload(f, cfg: LatticeConfig) -> np.ndarray:
    """f.raw's array: the bf16 bits for bf16 storage (from a bf16 tensor,
    a bf16 array, or float32 holding bf16 values), else the state in the
    config's dtype; raises ValueError on another float dtype, which the
    meta would misname."""
    name = dtype_name(cfg.dtype)
    if name == "bfloat16":
        if not (torch.is_tensor(f) and f.dtype == torch.bfloat16):
            f = state_tensor(f, "bfloat16", "cpu")
        return to_bf16_bits(f)
    f = to_numpy(f) if torch.is_tensor(f) else np.asarray(f)
    if f.dtype != np.dtype(name):
        raise ValueError(f"a {name} config's checkpoint takes a {name} state, got {f.dtype}")
    return f


def save(
    directory, step: int, f, walls, cfg: LatticeConfig, *, format: str = "raw"
) -> pathlib.Path:
    """<directory>/<step>.lbmckpt/ from a (9, NX, NY) state (a host array
    or a tensor on any device) and the (NX, NY) wall mask."""
    if format == "orbax":
        raise NotImplementedError(_ORBAX)
    if format != "raw":
        raise ValueError(f"unknown checkpoint format {format!r}; options: raw, orbax")
    payload = _payload(f, cfg)
    walls = to_numpy(walls) if torch.is_tensor(walls) else np.asarray(walls)
    d = pathlib.Path(directory) / f"{step}.lbmckpt"
    d.mkdir(parents=True, exist_ok=True)
    (d / "meta.json").write_text(json.dumps(_meta(step, payload.shape, cfg), indent=1))
    native.write_raw(str(d / "f.raw"), payload)
    native.write_raw(str(d / "walls.raw"), walls.astype(np.uint8))
    return d


def load(path) -> tuple[int, np.ndarray, np.ndarray, LatticeConfig]:
    """(step, f, walls, cfg) with host arrays, from a <step>.lbmckpt/
    directory of either package. f is in the stored dtype, or float32
    holding the exact values of a bf16 state."""
    d = pathlib.Path(path)
    if d.suffix == ".orbax":
        raise NotImplementedError(_ORBAX)
    meta = json.loads((d / "meta.json").read_text())
    cfg = _cfg_from_meta(meta)
    f = native.read_raw(str(d / "f.raw"), tuple(meta["f_shape"]), _RAW_DTYPES[meta["dtype"]])
    if meta["dtype"] == "bfloat16":
        f = to_numpy(from_bf16_bits(f, "cpu"))
    walls = native.read_raw(
        str(d / "walls.raw"), (meta["nx"], meta["ny"]), np.uint8
    ).astype(bool)
    return meta["step"], f, walls, cfg


def latest(directory) -> pathlib.Path | None:
    """The checkpoint of the highest step in `directory` (either
    package's formats, as the JAX latest(); load() refuses an orbax
    one), or None."""
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    ckpts = sorted(
        (p for p in d.iterdir() if p.suffix in (".lbmckpt", ".orbax")),
        key=lambda p: int(p.stem.split(".")[0]),
    )
    return ckpts[-1] if ckpts else None
