"""Checkpoint / resume: the raw format of
latticeboltzmann_tpu/utils/checkpoint.py, file for file, and a format of
the port's own that saves a row-sharded state shard by shard.

- <dir>/<step>.lbmckpt/ ("raw"): meta.json (the step, the config and the
  state's shape), f.raw (the (9, NX, NY) state in its storage dtype) and
  walls.raw (the (NX, NY) mask as uint8), written and read through
  utils/native.py. Either package reads the other's.
- <dir>/<step>.lbmshards/ ("sharded"): the raw format's meta.json fields
  (which the JAX _cfg_from_meta reads as they are) plus "shards" and
  "rows_per_shard" L, one f.<k>.raw per shard (shard k's (9, L, NY) rows
  of the state, in the raw format's storage dtype) and walls.raw. save()
  takes the shards of a sharded session (its shards(): the live buffers,
  one per mesh entry) and moves one shard to the host at a time, so no
  device and no host holds the whole state. load() returns the state
  gathered on the host, as the JAX load() does for its orbax format;
  load_shards(path, mesh) reads, for each shard of a mesh, only the rows
  that shard owns, one shard at a time as a session's load() asks for
  them, and the session copies each straight into its buffer on its
  device; it may restore onto another shard count (the counterpart of an
  orbax restore with a target sharding).

The state is Markov, so a resumed run continues bit for bit.

bf16: the raw files hold the bf16 bits as uint16 and meta.json says
"bfloat16", as the JAX package writes it. The port reads it without
numpy bf16 (no ml_dtypes): load() returns the state as float32 holding
the exact bf16 values, and a bf16 config's dtype is the string
"bfloat16", the port's name for it. The pair-DP backends save float64
with a float64 config, as the JAX CLI does: Simulation.state(), or in
the sharded format each shard's pair recombined on the host as state()
recombines it, one shard at a time.

The JAX package's orbax format is not ported (orbax is a JAX library):
format="orbax", and loading a <step>.orbax/ directory, raise
NotImplementedError naming format="sharded", the port's counterpart of
its one property, a sharded state saved without a whole state on one
device.
"""

from __future__ import annotations

import json
import pathlib
from collections.abc import Sequence

import numpy as np
import torch

from ..core.spec import NSPEEDS, LatticeConfig
from ..ops import df64
from ..ops.df64 import DS
from . import native
from .interop import from_bf16_bits, state_tensor, storage_dtype, to_bf16_bits, to_numpy

_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.bfloat16: "bfloat16"}
_CFG_DTYPES = {"float32": np.float32, "float64": np.float64, "bfloat16": "bfloat16"}
# what f.raw holds for each meta dtype
_RAW_DTYPES = {"float32": np.float32, "float64": np.float64, "bfloat16": np.uint16}
_ORBAX = ("the orbax checkpoint format is JAX-only and not ported (ROADMAP A6); its "
          "counterpart here, a row-sharded state saved shard by shard, is format='sharded'; "
          "else use format='raw'")
_SUFFIXES = {"raw": ".lbmckpt", "sharded": ".lbmshards"}


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
    directory, step: int, f, walls, cfg: LatticeConfig, *, format: str = "raw",
    shards=None,
) -> pathlib.Path:
    """<directory>/<step>.lbmckpt/ (format "raw") from a (9, NX, NY) state
    (a host array or a tensor on any device) and the (NX, NY) wall mask.

    format "sharded": <directory>/<step>.lbmshards/ from a list of shards
    in row order ((9, L, NY) tensors on any devices, or DS pairs: a
    sharded session's shards()), one shard moved to the host at a time; or
    from a whole state, a tensor, array or DS pair, cut into `shards` row
    blocks (a sharded.Mesh, or a count; default 1)."""
    if format == "orbax":
        raise NotImplementedError(_ORBAX)
    if format not in _SUFFIXES:
        raise ValueError(f"unknown checkpoint format {format!r}; options: raw, sharded, orbax")
    walls = to_numpy(walls) if torch.is_tensor(walls) else np.asarray(walls)
    d = pathlib.Path(directory) / f"{step}{_SUFFIXES[format]}"
    if format == "raw":
        payload = _payload(f, cfg)
        d.mkdir(parents=True, exist_ok=True)
        (d / "meta.json").write_text(json.dumps(_meta(step, payload.shape, cfg), indent=1))
        native.write_raw(str(d / "f.raw"), payload)
        native.write_raw(str(d / "walls.raw"), walls.astype(np.uint8))
        return d
    blocks = _row_blocks(f, shards, cfg)
    rows = cfg.nx // len(blocks)
    shape = (NSPEEDS, rows, cfg.ny)
    d.mkdir(parents=True, exist_ok=True)
    for k, block in enumerate(blocks):
        payload = _shard_payload(block, cfg)
        if payload.shape != shape:
            raise ValueError(f"shard {k} has shape {payload.shape}, expected {shape}")
        native.write_raw(str(d / f"f.{k}.raw"), payload)
        del payload
    native.write_raw(str(d / "walls.raw"), walls.astype(np.uint8))
    # the meta last: a directory without one is a save that did not end
    meta = {**_meta(step, (NSPEEDS, cfg.nx, cfg.ny), cfg), "shards": len(blocks),
            "rows_per_shard": rows}
    (d / "meta.json").write_text(json.dumps(meta, indent=1))
    return d


def _row_blocks(f, shards, cfg: LatticeConfig) -> list:
    """The shards save() writes: a list or tuple of shards as given, else
    the whole state f cut into `shards` row blocks (views)."""
    if isinstance(f, (list, tuple)):
        if shards is not None:
            raise ValueError("shards= cuts a whole state; a list of shards is saved as it is")
        if not f or cfg.nx % len(f):
            raise ValueError(f"{len(f)} shards do not split NX={cfg.nx} evenly")
        return list(f)
    n = 1 if shards is None else getattr(shards, "size", shards)
    if cfg.nx % n:
        raise ValueError(f"NX={cfg.nx} not divisible by {n} shards")
    rows = cfg.nx // n

    def cut(x, k):
        return x[:, k * rows:(k + 1) * rows]

    if isinstance(f, DS):
        return [DS(cut(f.hi, k), cut(f.lo, k)) for k in range(n)]
    return [cut(f, k) for k in range(n)]


def _shard_payload(block, cfg: LatticeConfig) -> np.ndarray:
    """One shard's f.<k>.raw array: _payload's, or for a DS pair its float64
    recombination, made on the host as Simulation.state() makes it
    (df64.to_f64), so the device holds nothing beyond the pair."""
    if not isinstance(block, DS):
        return _payload(block, cfg)
    if dtype_name(cfg.dtype) != "float64":
        raise ValueError("a ds pair's checkpoint takes a float64 config")
    return df64.to_f64(block)


def load(path) -> tuple[int, np.ndarray, np.ndarray, LatticeConfig]:
    """(step, f, walls, cfg) with host arrays, from a <step>.lbmckpt/
    directory of either package, or a <step>.lbmshards/ directory (f
    gathered from its shards). f is in the stored dtype, or float32
    holding the exact values of a bf16 state."""
    d = pathlib.Path(path)
    if d.suffix == ".orbax":
        raise NotImplementedError(_ORBAX)
    meta = json.loads((d / "meta.json").read_text())
    cfg = _cfg_from_meta(meta)
    if d.suffix == _SUFFIXES["sharded"]:
        f = np.concatenate([_shard_file(d, meta, k) for k in range(meta["shards"])], axis=1)
    else:
        f = native.read_raw(str(d / "f.raw"), tuple(meta["f_shape"]),
                            _RAW_DTYPES[meta["dtype"]])
    if meta["dtype"] == "bfloat16":
        f = to_numpy(from_bf16_bits(f, "cpu"))
    return meta["step"], f, _walls(d, meta), cfg


def _walls(d: pathlib.Path, meta: dict) -> np.ndarray:
    return native.read_raw(
        str(d / "walls.raw"), (meta["nx"], meta["ny"]), np.uint8
    ).astype(bool)


def _shard_file(d: pathlib.Path, meta: dict, k: int) -> np.ndarray:
    """f.<k>.raw of a sharded checkpoint as a read-only memory map of its
    (9, L, NY) rows (nothing is read until a slice is taken); raises,
    naming the file, when it is missing or not of that size."""
    path = d / f"f.{k}.raw"
    shape = (NSPEEDS, meta["rows_per_shard"], meta["ny"])
    dtype = np.dtype(_RAW_DTYPES[meta["dtype"]])
    want = int(np.prod(shape)) * dtype.itemsize
    if not path.is_file():
        raise FileNotFoundError(f"sharded checkpoint {d}: shard file {path.name} is missing")
    size = path.stat().st_size
    if size != want:
        raise ValueError(f"sharded checkpoint {d}: shard file {path.name} holds {size} bytes, "
                         f"expected {want} ({shape} {dtype.name})")
    return np.memmap(path, dtype=dtype, mode="r", shape=shape)


class ShardFiles(Sequence):
    """The state of a <step>.lbmshards/ checkpoint cut for a mesh: item k
    reads the rows that mesh shard k owns, [k L', (k + 1) L') with L' = NX
    / mesh.size, from the shard files that hold them (memory maps: only
    those rows are read), as a (9, L', NY) host tensor in the storage
    dtype (bf16 from its bits), or with pair=True the df64.DS pair of the
    float64 rows, split on the host as df64.from_f64 splits. Each item is
    read when it is asked for, and a session's load() copies it straight
    into shard k's buffer on its device: the host holds one shard at a
    time and the devices no copy of one."""

    def __init__(self, d: pathlib.Path, meta: dict, mesh, pair: bool):
        if meta["nx"] % mesh.size:
            raise ValueError(f"NX={meta['nx']} not divisible by {mesh.size} shards")
        if pair and meta["dtype"] != "float64":
            raise ValueError(f"pair=True splits a float64 checkpoint, not {meta['dtype']}")
        self.size, self.pair, self.meta = mesh.size, pair, meta
        self.rows = meta["nx"] // mesh.size
        # every file checked before any is read
        self._files = [_shard_file(d, meta, j) for j in range(meta["shards"])]

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, k: int):
        if not 0 <= k < len(self):
            raise IndexError(k)
        a, b, held = k * self.rows, (k + 1) * self.rows, self.meta["rows_per_shard"]
        block = np.concatenate(
            [self._files[j][:, max(a, j * held) - j * held:min(b, (j + 1) * held) - j * held]
             for j in range(a // held, (b - 1) // held + 1)], axis=1)
        if self.meta["dtype"] == "bfloat16":
            return from_bf16_bits(block, "cpu")
        if self.pair:
            return df64.from_f64(block, "cpu")
        return torch.from_numpy(block)


def load_shards(path, mesh, *, pair: bool = False):
    """(step, shards, walls, cfg) from a <step>.lbmshards/ directory for a
    mesh (parallel/sharded.Mesh) of any shard count that divides NX:
    shards is a ShardFiles, read shard by shard as a session's load()
    takes it (pair=True: DS pairs, for the ds sessions); walls and cfg as
    load()'s. Raises, naming the file, on a missing or wrong-sized shard
    file."""
    d = pathlib.Path(path)
    if d.suffix != _SUFFIXES["sharded"]:
        raise ValueError(f"{d} is no {_SUFFIXES['sharded']} checkpoint")
    meta = json.loads((d / "meta.json").read_text())
    return meta["step"], ShardFiles(d, meta, mesh, pair), _walls(d, meta), _cfg_from_meta(meta)


def latest(directory) -> pathlib.Path | None:
    """The checkpoint of the highest step in `directory` (either
    package's formats, as the JAX latest(), and the sharded one; load()
    refuses an orbax one), or None."""
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    ckpts = sorted(
        (p for p in d.iterdir() if p.suffix in (".lbmckpt", ".orbax", ".lbmshards")),
        key=lambda p: int(p.stem.split(".")[0]),
    )
    return ckpts[-1] if ckpts else None
