"""The fused double-single (f32-pair) kernel's runner surface, backend
'cuda-ds64': twin of the local form of
latticeboltzmann_tpu/ops/fused_ds_kernel.py (`_make_ds_pass`, `run_steps`).

One launch of csrc/lbm_ds_step.cu advances the whole pair state one step
out of place: forcing at column 0 at pair precision, periodic pull, BGK
collision at pair precision and masked bounce-back. `exact` selects the
collision: ds_engine.collide_planes (the exact tier, bitwise the
'torch-ds64' arithmetic) or ds_engine.collide_planes_fast (the fast tier,
the default, as on 'pallas-ds64'). The `step` wrapper launches the kernel
for CUDA tensors and takes `step_reference`, its plain PyTorch version,
for CPU tensors; anything else raises.

The ext-halo form (`ext_launcher`; plain version
`step_reference_ext`) is the same step on one shard of the row-sharded
path (parallel/sharded.py), the counterpart of the JAX kernel's
ext_halo=True form (ops/fused_ds_kernel.py:242-254 there): a launch
writes a range of the shard's local rows, and the rows beyond the shard
come from two halo rows of each pair component, all 9 speed planes of a
ring neighbour's boundary row. Its launches are counted in EXT_LAUNCHES.

The temporal form (`temporal_step`; plain versions `temporal_reference`
and, tile by tile, `temporal_reference_blocked`;
csrc/lbm_ds_temporal_step.cu) is the JAX kernel's temporal blocking: one
launch runs a pass of L pair steps from one pair to the other in a tile
of shared memory, one state through device memory per pass where the
one-step kernel moves one per step; `temporal_info` reads the tile the
card gives it and the deepest pass it takes. `Session` (and so the
'cuda-ds64' backend and `run_steps`) runs n steps as n // T passes of T =
DS_TEMPORAL and one of the rest, as the JAX run_steps does with
divmod(n_steps, T), at the fast tier; temporal=1, a shape the temporal
form does not take (NY no multiple of 4) and the exact tier run the
one-step kernel, a choice by shape and by tier: the exact tier's passes
are slower than its one-step kernel on an H100 (PERF.md, row 3-T).
The two forms' launches are counted apart: LAUNCHES (one step) and
TEMPORAL_LAUNCHES (passes; their steps in TEMPORAL_STEPS). Every result is
bitwise independent of T, as the JAX kernel's is.

The ext-halo temporal form (`ext_temporal_launcher`; plain versions
`temporal_reference_ext` and, tile by tile, `temporal_reference_ext_blocked`)
is the temporal form on one shard of the row-sharded path, the JAX
kernel's ext_halo=True form at temporal=DS_TEMPORAL as its sharded runner
drives it (_get_sharded_runner, :385-472 there): a launch runs a pass of L
pair steps and writes a range of the shard's local rows, and the source
rows beyond the shard come from two halo blocks of Td >= L rows of each
pair component (the ring neighbours' boundary rows, all 9 speed planes)
with their static class rows. Its launches are counted in
EXT_TEMPORAL_LAUNCHES (their steps in EXT_TEMPORAL_STEPS).

State is the unpadded DS pair of (9, NX, NY) float32 planes. The TPU
kernel's mirror-pad lanes, pad re-mirroring and 8-row halo blocks have no
counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import numpy as np
import torch

from ..core.spec import E, NSPEEDS, LatticeConfig
from ..utils.interop import storage_dtype
from . import cuda_build, df64, ds_engine, fused_kernel, stream_collide
from .df64 import DS
from .fused_kernel import ShardPlane, check_device, check_ext_launch, check_solid_plane

# kernel launches made by `step` (the one-step form), by the ext-halo
# form, by `temporal_step` (the temporal form; TEMPORAL_STEPS: the steps
# its passes ran) and by the ext-halo temporal form, for callers that
# must show a run went through a kernel (chip_smoke.py resets and reads
# them)
LAUNCHES = 0
EXT_LAUNCHES = 0
TEMPORAL_LAUNCHES = 0
TEMPORAL_STEPS = 0
EXT_TEMPORAL_LAUNCHES = 0
EXT_TEMPORAL_STEPS = 0

# the JAX kernel's default temporal-blocking depth (its DS_TEMPORAL), the
# steps of a Session's passes; results are bitwise independent of it
DS_TEMPORAL = 4
# the temporal form's columns of one 16-byte vector: NY must be a multiple
TEMPORAL_COLUMNS = 4

# device-memory bytes per site update: two f32 components, 9 reads and
# 9 writes each (the 1 B mask read of the masked variant not counted)
BYTES_PER_SITE_DS = 2 * 2 * NSPEEDS * 4


@functools.lru_cache(maxsize=64)
def kernel_constants_ds(cfg: LatticeConfig, exact: bool) -> tuple[float, ...]:
    """The host floats the kernel takes, split on the host from float64
    exactly as ds_engine splits them, in the order of Params in
    csrc/lbm_ds.cuh.

    exact=False (the fast tier, 18 floats): the pairs c1, iw0, iw14,
    iw58, c3, csixth (the (hi, lo) of their split_const quads: the kernel
    forms a product's error by one FMA and needs no presplit halves), one,
    a14, a58. exact=True (20 floats): the pairs one, itau, c3, c45, c15,
    w0, w14, w58, a14, a58. Cached: `step` reads them at every launch."""
    if exact:
        vals = [x for v in ds_engine._const_values(cfg).values()
                for x in df64.const_literal(v)]
    else:
        vals = [x for v in ds_engine._fast_const_values(cfg).values() for x in v[:2]]
    return tuple(float(x) for x in vals)


def step_reference(
    hi: torch.Tensor, lo: torch.Tensor, solid: torch.Tensor | None,
    cfg: LatticeConfig, exact: bool,
) -> DS:
    """Plain PyTorch version of the kernel's one step: pair forcing,
    pull, the exact or fast collision, bounce-back with wall-f0
    passthrough. solid: (NX, NY) uint8 codes (0 fluid, 1 bounce-back),
    or None for the wall-free variant. Returns a new pair."""
    dev = hi.device
    walls = (
        torch.zeros(hi.shape[1:], dtype=torch.bool, device=dev)
        if solid is None else solid != 0
    )
    C = ds_engine._consts(cfg, dev) if exact else ds_engine._consts_fast(cfg, dev)
    collide = ds_engine.collide_planes if exact else ds_engine.collide_planes_fast
    pulled = ds_engine.pull(ds_engine.apply_source(DS(hi, lo), walls, cfg, C))
    planes = [DS(pulled.hi[s], pulled.lo[s]) for s in range(NSPEEDS)]
    return ds_engine.bounce_back(pulled, collide(planes, C), walls)


def _require_float64(cfg: LatticeConfig) -> None:
    if storage_dtype(cfg.dtype) != torch.float64:
        raise ValueError(
            "the ds kernel carries DP-class state; construct the LatticeConfig "
            "with dtype=np.float64 (the host-side precision of the pair)"
        )


def _check(src: DS, dst: DS, solid, cfg: LatticeConfig, has_walls: bool) -> None:
    """The checks of fused_kernel.step, for both pair components."""
    _require_float64(cfg)
    dev = src.hi.device
    check_device(src.hi)
    shape = (NSPEEDS, cfg.nx, cfg.ny)
    named = (("src.hi", src.hi), ("src.lo", src.lo), ("dst.hi", dst.hi), ("dst.lo", dst.lo))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, src.hi on {dev}")
    # out of place, four distinct buffers: the pull never reads what the
    # step writes, and hi and lo never share storage
    ptrs = [t.untyped_storage().data_ptr() for _, t in named]
    if len(set(ptrs)) != 4:
        raise ValueError("step is out of place: src.hi, src.lo, dst.hi and dst.lo "
                         "must be four distinct buffers")
    if has_walls:
        check_solid_plane(solid, shape[1:], dev, max_code=1)


def step(
    src: DS,
    dst: DS,
    solid: torch.Tensor | None,
    cfg: LatticeConfig,
    *,
    has_walls: bool,
    exact: bool = False,
) -> DS:
    """One step src -> dst; returns dst. On CUDA tensors it launches the
    kernel (masked variant when has_walls, fast tier unless exact) on the
    current stream and counts it in LAUNCHES; on CPU tensors it writes
    step_reference's result. Raises on anything the kernel does not
    take, and on any other device."""
    global LAUNCHES
    _check(src, dst, solid, cfg, has_walls)
    if src.hi.device.type == "cpu":
        out = step_reference(src.hi, src.lo, solid if has_walls else None, cfg, exact)
        dst.hi.copy_(out.hi)
        dst.lo.copy_(out.lo)
        return dst
    consts = kernel_constants_ds(cfg, exact)
    params = (ctypes.c_float * len(consts))(*consts)
    rc = cuda_build.load_library().lbm_stream_collide_ds_launch(
        src.hi.data_ptr(), src.lo.data_ptr(), dst.hi.data_ptr(), dst.lo.data_ptr(),
        solid.data_ptr() if has_walls else None,
        cfg.nx, cfg.ny, int(has_walls), int(exact), ctypes.addressof(params),
        torch.cuda.current_stream(src.hi.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"lbm_stream_collide_ds launch failed: cudaError {rc}")
    LAUNCHES += 1
    return dst


def step_reference_ext(
    hi: torch.Tensor, lo: torch.Tensor, halo: tuple[DS, DS], solid: ShardPlane | None,
    cfg: LatticeConfig, exact: bool,
) -> DS:
    """Plain PyTorch version of the ext-halo form on a whole shard:
    step_reference on the halo-extended pair (top, block, bot) with its
    class rows, then the shard's L rows. halo: (top, bot), pairs of
    (9, NY) rows above and below the shard; solid: a ShardPlane of codes
    0/1, or None for the wall-free variant. Returns a new pair."""
    top, bot = halo
    hi_ext = torch.cat([top.hi[:, None], hi, bot.hi[:, None]], dim=1)
    lo_ext = torch.cat([top.lo[:, None], lo, bot.lo[:, None]], dim=1)
    walls = None if solid is None else torch.cat([solid.top[None], solid.plane, solid.bot[None]])
    out = step_reference(hi_ext, lo_ext, walls, cfg, exact)
    return DS(out.hi[:, 1:-1], out.lo[:, 1:-1])


def _check_ext(src: DS, dst: DS, halo, solid, cfg: LatticeConfig, has_walls: bool,
               row0: int, rows: int) -> None:
    """The checks of _check for a shard, its row range and its halos."""
    _require_float64(cfg)
    named = (("src.hi", src.hi), ("src.lo", src.lo), ("dst.hi", dst.hi), ("dst.lo", dst.lo))
    n_rows = check_ext_launch(named, halo, torch.float32, cfg, row0, rows)
    if len({t.untyped_storage().data_ptr() for _, t in named}) != 4:
        raise ValueError("step is out of place: src.hi, src.lo, dst.hi and dst.lo "
                         "must be four distinct buffers")
    if has_walls:
        if not isinstance(solid, ShardPlane):
            raise ValueError("the masked variant needs a ShardPlane")
        check_solid_plane(solid.plane, (n_rows, cfg.ny), src.hi.device, max_code=1)
        for t in (solid.top, solid.bot):
            check_solid_plane(t[None], (1, cfg.ny), src.hi.device, max_code=1)


def ext_launcher(
    src: DS,
    dst: DS,
    halo,
    solid: ShardPlane | None,
    cfg: LatticeConfig,
    *,
    has_walls: bool,
    exact: bool = False,
    row0: int = 0,
    rows: int | None = None,
) -> Callable[[], None]:
    """Validate one ext-halo launch and return it as a call with no
    arguments, to be made any number of times: it steps the local rows
    [row0, row0 + rows) (default: all) of the shard pair src -> dst from
    the buffers' contents at that time.

    src, dst: the shard's pairs of (9, L, NY) float32 blocks; halo:
    (top, bot), pairs of (9, NY) rows above and below the shard, needed
    only when the range touches row 0 or L - 1 (else None); solid: a
    ShardPlane of codes 0/1 (read when has_walls). On CUDA tensors the
    call launches the kernel on the current stream and counts it in
    EXT_LAUNCHES; on CPU tensors it writes step_reference_ext's rows."""
    rows = src.hi.shape[1] - row0 if rows is None else rows
    _check_ext(src, dst, halo, solid, cfg, has_walls, row0, rows)
    if src.hi.device.type == "cpu":
        def reference():
            if halo is None:
                zero = torch.zeros_like(src.hi[:, 0])
                h = (DS(zero, zero), DS(zero, zero))
            else:
                h = halo
            out = step_reference_ext(src.hi, src.lo, h, solid if has_walls else None,
                                     cfg, exact)
            dst.hi[:, row0:row0 + rows].copy_(out.hi[:, row0:row0 + rows])
            dst.lo[:, row0:row0 + rows].copy_(out.lo[:, row0:row0 + rows])

        return reference

    consts = kernel_constants_ds(cfg, exact)
    params = (ctypes.c_float * len(consts))(*consts)
    fn = cuda_build.load_library().lbm_stream_collide_ds_ext_launch
    top, bot = halo if halo is not None else (DS(None, None), DS(None, None))
    plane = solid if has_walls else ShardPlane(None, None, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (ptr(src.hi), ptr(src.lo), ptr(dst.hi), ptr(dst.lo), ptr(top.hi), ptr(top.lo),
            ptr(bot.hi), ptr(bot.lo), ptr(plane.plane), ptr(plane.top), ptr(plane.bot),
            src.hi.shape[1], cfg.ny, row0, rows, int(has_walls), int(exact),
            ctypes.addressof(params))
    device = src.hi.device

    def launch():
        global EXT_LAUNCHES
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"lbm_stream_collide_ds ext-halo launch failed: cudaError {rc}")
        EXT_LAUNCHES += 1

    launch.host_args = params  # alive as long as the call
    return launch


def temporal_reference(hi: torch.Tensor, lo: torch.Tensor, solid: torch.Tensor | None,
                       cfg: LatticeConfig, exact: bool, steps: int) -> DS:
    """Plain PyTorch version of the temporal form: `steps` chained
    step_reference calls from (hi, lo). solid: (NX, NY) uint8 codes 0/1,
    or None for the wall-free variant. Returns a new pair."""
    fused_kernel._check_temporal(steps)
    out = DS(hi, lo)
    for _ in range(steps):
        out = step_reference(out.hi, out.lo, solid, cfg, exact)
    return out


def temporal_reference_blocked(hi: torch.Tensor, lo: torch.Tensor, solid: torch.Tensor | None,
                               cfg: LatticeConfig, exact: bool, steps: int, tile) -> DS:
    """Plain PyTorch version of the temporal form's tiling:
    temporal_reference's result, computed the way
    csrc/lbm_ds_temporal_step.cu computes it, one pass of `steps` steps
    tile by tile: output tiles of fused_kernel.flat_output(tile,
    torch.float32, steps) sites (ragged at the last row and column), each
    from its source pair and its classes grown by `steps` on each side
    with periodic wrap by modulo indices (a site may appear more than
    once), levels each one site smaller on each side, the pair forcing at
    fluid sources of GLOBAL column 0 with the guard read at the level
    being read, then the collision at the tier and bounce-back. tile: any
    rows and width (a fused_kernel.FlatTile) that leave an output tile
    (temporal_info gives the kernel's on a card). Returns a new pair."""
    nx = hi.shape[1]
    return _blocked(hi, lo, solid, cfg, exact, steps, tile, nx,
                    lambda r0, re: torch.arange(r0 - steps, r0 + re + steps) % nx)


def _blocked(hi, lo, solid, cfg: LatticeConfig, exact: bool, steps: int, tile, n_rows: int,
             source_rows) -> DS:
    """One pass of `steps` steps tile by tile over n_rows output rows of
    every column: output tiles of flat_output(tile, float32, steps) sites,
    tile row r0 of them from the re + 2 steps rows source_rows(r0, re) of
    hi, lo and solid (None: wall-free). Returns an (9, n_rows, NY) pair."""
    fused_kernel._check_temporal(steps)
    tile = fused_kernel.FlatTile(*tile)
    R, C = fused_kernel.flat_output(tile, torch.float32, steps)
    if min(R, C) < 1:
        raise ValueError(f"tile {tile} leaves no output tile at {steps} steps")
    dev = hi.device
    walls = (torch.zeros(hi.shape[1:], dtype=torch.bool, device=dev) if solid is None
             else solid != 0)
    consts = ds_engine._consts(cfg, dev) if exact else ds_engine._consts_fast(cfg, dev)
    shape = (NSPEEDS, n_rows, cfg.ny)
    out = DS(hi.new_empty(shape), lo.new_empty(shape))
    for r0 in range(0, n_rows, R):
        re = min(R, n_rows - r0)
        rows = source_rows(r0, re).to(dev)
        for c0 in range(0, cfg.ny, C):
            ce = min(C, cfg.ny - c0)
            got = _tile_pass(hi, lo, walls, cfg, consts, exact, rows, c0, ce, steps)
            out.hi[:, r0:r0 + re, c0:c0 + ce] = got.hi
            out.lo[:, r0:r0 + re, c0:c0 + ce] = got.lo
    return out


# the forced speeds and the sign of their delta (+1 gains, -1 loses)
_FORCED = ((1, 1), (3, -1), (5, 1), (6, -1), (7, -1), (8, 1))


def _tile_pass(hi, lo, walls, cfg: LatticeConfig, consts: dict, exact: bool, rows: torch.Tensor,
               c0: int, ce: int, L: int) -> DS:
    """L levels of one tile: the len(rows) - 2 L x ce output sites at
    column c0 after L pair steps, through a source window of the rows
    `rows` of hi, lo and walls and the columns grown by L on each side."""
    cols = torch.arange(c0 - L, c0 + ce + L, device=hi.device) % cfg.ny
    cur = DS(hi[:, rows][:, :, cols], lo[:, rows][:, :, cols])
    wall = walls[rows][:, cols]
    collide = ds_engine.collide_planes if exact else ds_engine.collide_planes_fast
    a14, a58 = consts["a14"], consts["a58"]
    for _ in range(L):
        def sp(s):
            return DS(cur.hi[s], cur.lo[s])

        ok = ((cols == 0)[None, :] & ~wall
              & df64.gt_zero(df64.sub(sp(6), a58)) & df64.gt_zero(df64.sub(sp(3), a14))
              & df64.gt_zero(df64.sub(sp(7), a58)))
        f_hi, f_lo = cur.hi.clone(), cur.lo.clone()
        for s, sign in _FORCED:
            a = a14 if s in (1, 3) else a58
            sel = df64.where(ok, df64.add(sp(s), a if sign > 0 else df64.neg(a)), sp(s))
            f_hi[s], f_lo[s] = sel.hi, sel.lo
        h, w = cur.hi.shape[1], cur.hi.shape[2]
        pulled = DS(*(torch.stack([
            x[s, 1 - int(E[s, 0]):h - 1 - int(E[s, 0]), 1 - int(E[s, 1]):w - 1 - int(E[s, 1])]
            for s in range(NSPEEDS)]) for x in (f_hi, f_lo)))
        wall = wall[1:-1, 1:-1]
        planes = [DS(pulled.hi[s], pulled.lo[s]) for s in range(NSPEEDS)]
        cur = ds_engine.bounce_back(pulled, collide(planes, consts), wall)
        cols = cols[1:-1]
    return cur


def temporal_info(exact: bool = False, has_walls: bool = True, device=None,
                  ext: bool = False) -> dict:
    """What a card gives the temporal form (ext: its ext-halo form) at a
    tier and a variant, as csrc/lbm_ds_temporal_step.cu decides it from
    the card's shared memory: the tile's `rows` and `width`, `max_steps`
    (the deepest pass the tile takes, fused_kernel.tile_max_steps),
    `registers` and `local_bytes` (stack and spills) per thread,
    `ctas_per_sm` and `shared_bytes_per_cta`. Needs a CUDA card (default:
    the current one); read once per card."""
    index = None if device is None else torch.device(device).index
    return _temporal_info(bool(exact), bool(has_walls),
                          torch.cuda.current_device() if index is None else index, bool(ext))


@functools.cache
def _temporal_info(exact: bool, has_walls: bool, index: int, ext: bool = False) -> dict:
    out = (ctypes.c_int64 * 6)()
    name = "lbm_ds_temporal_steps_ext_info" if ext else "lbm_ds_temporal_steps_info"
    with torch.cuda.device(index):
        rc = getattr(cuda_build.load_library(), name)(int(exact), int(has_walls), out)
    if rc != 0:
        raise RuntimeError(f"{name} failed: cudaError {rc}")
    tile = fused_kernel.FlatTile(out[4], out[5])
    return {"registers": out[0], "ctas_per_sm": out[1], "shared_bytes_per_cta": out[2],
            "local_bytes": out[3], "rows": tile.rows, "width": tile.width,
            "max_steps": fused_kernel.tile_max_steps(tile, torch.float32)}


def temporal_form_takes(ny: int) -> bool:
    """Whether the temporal form takes rows of ny columns: whole 16-byte
    vectors of float32."""
    return ny % TEMPORAL_COLUMNS == 0


def _check_temporal_pass(steps: int, ny: int, device: torch.device, exact: bool,
                         has_walls: bool) -> None:
    """Raise ValueError unless the temporal form takes a pass of `steps`
    steps on rows of ny columns on `device`: an integer depth in [1,
    fused_kernel.FLAT_MAX_TEMPORAL], whole 16-byte vectors a row and, on a
    card, no deeper than its tile takes (temporal_info)."""
    fused_kernel._check_temporal(steps)
    if not temporal_form_takes(ny):
        raise ValueError(f"the ds temporal form needs NY a multiple of {TEMPORAL_COLUMNS} "
                         f"columns (one 16-byte vector), got NY {ny}; temporal=1 runs one "
                         "step per launch on any shape")
    if device.type == "cuda":
        info = temporal_info(exact, has_walls, device)
        if steps > info["max_steps"]:
            raise ValueError(f"a pass of {steps} steps leaves no output tile in the ds temporal "
                             f"form's {info['rows']}x{info['width']} tile on {device}: it takes "
                             f"at most {info['max_steps']}")


def temporal_step(
    src: DS,
    dst: DS,
    solid: torch.Tensor | None,
    cfg: LatticeConfig,
    steps: int,
    *,
    has_walls: bool,
    exact: bool = False,
) -> DS:
    """One pass of `steps` pair steps src -> dst; returns dst. src, dst,
    solid, has_walls and exact as step's; NY a multiple of 4, else
    ValueError. On CUDA tensors it launches the temporal kernel on the
    current stream and counts it in TEMPORAL_LAUNCHES and TEMPORAL_STEPS; a buffer or solid
    plane not aligned to 16 bytes, or more steps than the card's tile takes
    (temporal_info), raise ValueError, and nothing runs in their place. On
    CPU tensors it writes temporal_reference's result. Raises on anything
    the kernel does not take, and on any other device."""
    global TEMPORAL_LAUNCHES, TEMPORAL_STEPS
    _check(src, dst, solid, cfg, has_walls)
    _check_temporal_pass(steps, cfg.ny, src.hi.device, exact, has_walls)
    if src.hi.device.type == "cpu":
        out = temporal_reference(src.hi, src.lo, solid if has_walls else None, cfg, exact, steps)
        dst.hi.copy_(out.hi)
        dst.lo.copy_(out.lo)
        return dst
    align = fused_kernel.WIDE_ALIGN
    pointers = [t.data_ptr() for t in (*src, *dst)] + ([solid.data_ptr()] if has_walls else [])
    if any(ptr % align for ptr in pointers):
        raise ValueError(f"the ds temporal form needs buffers aligned to {align} bytes; "
                         f"pointers mod {align}: {[ptr % align for ptr in pointers]}")
    consts = kernel_constants_ds(cfg, exact)
    params = (ctypes.c_float * len(consts))(*consts)
    rc = cuda_build.load_library().lbm_ds_temporal_steps_launch(
        src.hi.data_ptr(), src.lo.data_ptr(), dst.hi.data_ptr(), dst.lo.data_ptr(),
        solid.data_ptr() if has_walls else None, cfg.nx, cfg.ny, int(has_walls), int(exact),
        steps, ctypes.addressof(params),
        torch.cuda.current_stream(src.hi.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"lbm_ds_temporal_steps launch failed: cudaError {rc}")
    TEMPORAL_LAUNCHES += 1
    TEMPORAL_STEPS += steps
    return dst


# --- the ext-halo temporal form (a shard's passes) ---------------------------


def _extended(hi, lo, halo, solid):
    """The halo-extended block of a shard: (hi, lo, walls, Td) with the
    top halo's Td rows, the shard's rows and the bottom halo's, walls
    from a ShardPlane with (Td, NY) class rows, or None."""
    top, bot = halo
    depth = top.hi.shape[1]
    hi_ext = torch.cat([top.hi, hi, bot.hi], dim=1)
    lo_ext = torch.cat([top.lo, lo, bot.lo], dim=1)
    walls = None if solid is None else torch.cat([solid.top, solid.plane, solid.bot])
    return hi_ext, lo_ext, walls, depth


def temporal_reference_ext(hi: torch.Tensor, lo: torch.Tensor, halo: tuple[DS, DS],
                           solid: ShardPlane | None, cfg: LatticeConfig, exact: bool,
                           steps: int) -> DS:
    """Plain PyTorch version of the ext-halo temporal form on a whole
    shard: `steps` chained step_reference calls on the halo-extended pair
    (top Td rows, the shard, bottom Td rows) with its class rows, then the
    shard's rows. After steps <= Td steps the extended block's own x wrap
    has not reached them. halo: (top, bot), pairs of (9, Td, NY) blocks,
    the Td rows above and below the shard; solid: a ShardPlane of codes
    0/1 whose top and bot are the halo rows' (Td, NY) class rows, or None
    for the wall-free variant. Returns a new pair."""
    hi_ext, lo_ext, walls, depth = _extended(hi, lo, halo, solid)
    if steps > depth:
        raise ValueError(f"a pass of {steps} steps reads {steps} halo rows a side; the halos "
                         f"hold {depth}")
    out = temporal_reference(hi_ext, lo_ext, walls, cfg, exact, steps)
    n = hi.shape[1]
    return DS(out.hi[:, depth:depth + n], out.lo[:, depth:depth + n])


def temporal_reference_ext_blocked(hi: torch.Tensor, lo: torch.Tensor, halo: tuple[DS, DS],
                                   solid: ShardPlane | None, cfg: LatticeConfig, exact: bool,
                                   steps: int, tile, row0: int = 0,
                                   rows: int | None = None) -> DS:
    """Plain PyTorch version of the ext-halo temporal form's tiling: the
    rows [row0, row0 + rows) (default: to the shard's end) of
    temporal_reference_ext's result, computed the way
    csrc/lbm_ds_temporal_step.cu's ext-halo form computes them: output
    tiles of fused_kernel.flat_output(tile, torch.float32, steps) sites
    laid from row0, each from its source rows grown by `steps` a side,
    where local row q < 0 reads top halo row Td + q and q >= Ls reads
    bottom halo row q - Ls, columns by modulo, then the levels of
    temporal_reference_blocked. Raises where a tile would read past a halo.
    Returns a (9, rows, NY) pair."""
    n = hi.shape[1]
    rows = n - row0 if rows is None else rows
    if not (0 <= row0 and rows >= 1 and row0 + rows <= n):
        raise ValueError(f"rows [{row0}, {row0 + rows}) outside the shard's {n} rows")
    hi_ext, lo_ext, walls, depth = _extended(hi, lo, halo, solid)

    def source_rows(r0, re):
        q0, q1 = row0 + r0 - steps, row0 + r0 + re + steps
        if q0 < -depth or q1 > n + depth:
            raise ValueError(f"a tile at rows [{row0 + r0}, {row0 + r0 + re}) reads rows "
                             f"[{q0}, {q1}) past the {depth}-row halos of a {n}-row shard")
        return torch.arange(q0, q1) + depth

    return _blocked(hi_ext, lo_ext, walls, cfg, exact, steps, tile, rows, source_rows)


def check_ext_temporal_depth(steps: int, device, exact: bool, has_walls: bool) -> None:
    """Raise ValueError unless the ext-halo temporal form's tile on
    `device` takes a pass of `steps` steps (nothing to check on the
    CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    info = temporal_info(exact, has_walls, device, ext=True)
    if steps > info["max_steps"]:
        raise ValueError(f"a pass of {steps} steps leaves no output tile in the ds temporal "
                         f"form's {info['rows']}x{info['width']} tile on {device}: it takes "
                         f"at most {info['max_steps']}")


def _check_ext_temporal(src: DS, dst: DS, halo, solid, cfg: LatticeConfig, steps: int,
                        has_walls: bool, exact: bool, row0: int, rows: int) -> int:
    """The checks of ext_temporal_launcher; returns Td (0 without halo)."""
    _require_float64(cfg)
    fused_kernel._check_temporal(steps)
    named = (("src.hi", src.hi), ("src.lo", src.lo), ("dst.hi", dst.hi), ("dst.lo", dst.lo))
    check_device(src.hi)
    n_rows = src.hi.shape[1] if src.hi.dim() == 3 else -1
    shape = (NSPEEDS, n_rows, cfg.ny)
    for name, t in named:
        if t.dtype != torch.float32 or tuple(t.shape) != shape or n_rows < 1:
            raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != src.hi.device:
            raise ValueError(f"{name} must be contiguous and on src.hi's device")
    if not (0 <= row0 and rows >= 1 and row0 + rows <= n_rows):
        raise ValueError(f"rows [{row0}, {row0 + rows}) outside the shard's {n_rows} rows")
    if len({t.untyped_storage().data_ptr() for _, t in named}) != 4:
        raise ValueError("a pass is out of place: src.hi, src.lo, dst.hi and dst.lo "
                         "must be four distinct buffers")
    if not temporal_form_takes(cfg.ny):
        raise ValueError(f"the ds temporal form needs NY a multiple of {TEMPORAL_COLUMNS} "
                         f"columns (one 16-byte vector), got NY {cfg.ny}")
    dev = src.hi.device
    depth = 0
    if halo is not None:
        if len(halo) != 2:
            raise ValueError("halo must be (top, bot), pairs of (9, Td, NY) blocks")
        blocks = [t for side in halo for t in side]
        depth = blocks[0].shape[1] if blocks[0].dim() == 3 else 0
        for t in blocks:
            if (t.dtype != torch.float32 or tuple(t.shape) != (NSPEEDS, depth, cfg.ny)
                    or not t.is_contiguous() or t.device != dev or depth < 1):
                raise ValueError(f"halo blocks must be contiguous float32 (9, Td, {cfg.ny}) on "
                                 f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if steps > depth:
            raise ValueError(f"a pass of {steps} steps reads {steps} halo rows a side; the "
                             f"halos hold {depth}")
    if row0 - steps < -depth or row0 + rows + steps > n_rows + depth:
        raise ValueError(f"rows [{row0}, {row0 + rows}) of a {n_rows}-row shard read "
                         f"{steps} rows a side, past {depth} halo rows: give the halos")
    if has_walls:
        if not isinstance(solid, ShardPlane):
            raise ValueError("the masked variant needs a ShardPlane")
        check_solid_plane(solid.plane, (n_rows, cfg.ny), dev, max_code=1)
        if halo is not None:
            for t in (solid.top, solid.bot):
                check_solid_plane(t, (depth, cfg.ny), dev, max_code=1)
    if dev.type == "cuda":
        check_ext_temporal_depth(steps, dev, exact, has_walls)
        align = fused_kernel.WIDE_ALIGN
        tensors = [t for _, t in named]
        if halo is not None:
            tensors += [t for side in halo for t in side]
        if has_walls:
            tensors += [solid.plane] + ([solid.top, solid.bot] if halo is not None else [])
        if any(t.data_ptr() % align for t in tensors):
            raise ValueError(f"the ds temporal form needs buffers aligned to {align} bytes; "
                             f"pointers mod {align}: {[t.data_ptr() % align for t in tensors]}")
    return depth


def ext_temporal_launcher(
    src: DS,
    dst: DS,
    halo,
    solid: ShardPlane | None,
    cfg: LatticeConfig,
    steps: int,
    *,
    has_walls: bool,
    exact: bool = False,
    row0: int = 0,
    rows: int | None = None,
) -> Callable[[], None]:
    """Validate one launch of the ext-halo temporal form and return it as a
    call with no arguments, to be made any number of times: a pass of
    `steps` pair steps that writes the local rows [row0, row0 + rows)
    (default: all) of the shard pair src -> dst from the buffers' contents
    at that time.

    src, dst: the shard's pairs of (9, Ls, NY) float32 blocks, four
    distinct buffers, NY a multiple of 4; halo: (top, bot), pairs of (9,
    Td, NY) blocks, the Td >= steps rows above and below the shard, needed
    unless the pass reads only the shard's rows (row0 >= steps and row0 +
    rows + steps <= Ls; else None); solid: a ShardPlane of codes 0/1 whose
    top and bot are the halos' (Td, NY) class rows (read when has_walls).
    On CUDA tensors the call launches the kernel on the current stream
    and counts it in EXT_TEMPORAL_LAUNCHES and EXT_TEMPORAL_STEPS; a
    buffer not aligned to 16 bytes or a pass deeper than the card's tile
    takes raise ValueError here, and nothing runs in their place. On CPU
    tensors the call writes temporal_reference_ext's rows. Raises on
    anything the kernel does not take, and on any other device."""
    n_rows = src.hi.shape[1] if src.hi.dim() == 3 else 0
    rows = n_rows - row0 if rows is None else rows
    depth = _check_ext_temporal(src, dst, halo, solid, cfg, steps, has_walls, exact, row0, rows)
    if src.hi.device.type == "cpu":
        def reference():
            if halo is None:
                zero = src.hi.new_zeros((NSPEEDS, steps, cfg.ny))
                h = (DS(zero, zero), DS(zero, zero))
                plane = None
                if has_walls:
                    none = solid.plane.new_zeros((steps, cfg.ny))
                    plane = ShardPlane(solid.plane, none, none)
            else:
                h, plane = halo, solid if has_walls else None
            out = temporal_reference_ext(src.hi, src.lo, h, plane, cfg, exact, steps)
            dst.hi[:, row0:row0 + rows].copy_(out.hi[:, row0:row0 + rows])
            dst.lo[:, row0:row0 + rows].copy_(out.lo[:, row0:row0 + rows])

        return reference

    consts = kernel_constants_ds(cfg, exact)
    params = (ctypes.c_float * len(consts))(*consts)
    fn = cuda_build.load_library().lbm_ds_temporal_steps_ext_launch
    top, bot = halo if halo is not None else (DS(None, None), DS(None, None))
    plane = solid if has_walls else ShardPlane(None, None, None)
    if halo is None:
        plane = ShardPlane(plane.plane, None, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (ptr(src.hi), ptr(src.lo), ptr(dst.hi), ptr(dst.lo), ptr(top.hi), ptr(top.lo),
            ptr(bot.hi), ptr(bot.lo), ptr(plane.plane), ptr(plane.top), ptr(plane.bot),
            n_rows, cfg.ny, depth, row0, rows, int(has_walls), int(exact), steps,
            ctypes.addressof(params))
    device = src.hi.device

    def launch():
        global EXT_TEMPORAL_LAUNCHES, EXT_TEMPORAL_STEPS
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"lbm_ds_temporal_steps ext-halo launch failed: cudaError {rc}")
        EXT_TEMPORAL_LAUNCHES += 1
        EXT_TEMPORAL_STEPS += steps

    launch.host_args = params  # alive as long as the call
    return launch


class Session:
    """Persistent pair state for one lattice configuration on one
    device: the solid plane and four preallocated (9, NX, NY) float32
    buffers (hi and lo, in and out) that swap roles every launch. The
    masked variant runs when the mask has a solid site, the wall-free
    variant otherwise; `exact` selects the tier.

    temporal (default DS_TEMPORAL, the JAX kernel's): n steps run as n //
    T passes of T steps and one of n % T through the temporal form
    (temporal_step), each a pass between the two pairs; 1 runs one launch
    of the one-step kernel per step. A shape the temporal form does not
    take (NY no multiple of 4), and the exact tier, run one step per
    launch at any temporal: the exact tier's collision bounds it by issue
    already, and the halos a pass recomputes made its passes slower than
    its one-step kernel on an H100 (PERF.md, row 3-T). The attribute
    `temporal` is the depth that runs. A temporal that is no integer in [1,
    fused_kernel.FLAT_MAX_TEMPORAL], or on a card a pass deeper than its
    tile takes, raises ValueError here. Every result is bitwise the same.

    Usage:
        sess = Session(cfg, walls, device="cuda")
        sess.load(f)       # copy a DS pair in
        sess.advance(n)    # n steps, no host sync
        sess.block()       # completion barrier
        f = sess.state()   # a copy; the session keeps running
    """

    def __init__(self, cfg: LatticeConfig, walls, *, device: str | torch.device,
                 exact: bool = False, temporal: int = DS_TEMPORAL):
        _require_float64(cfg)
        walls_np = np.asarray(walls, dtype=bool)
        if walls_np.shape != (cfg.nx, cfg.ny):
            raise ValueError(f"walls shape {walls_np.shape} != {(cfg.nx, cfg.ny)}")
        self.cfg = cfg
        self.exact = exact
        self.device = torch.device(device)
        self.has_walls = bool(walls_np.any())
        self.solid = torch.as_tensor(walls_np.astype(np.uint8), device=self.device)
        fused_kernel._check_temporal(temporal)
        self.temporal = temporal if temporal_form_takes(cfg.ny) and not exact else 1
        if self.temporal > 1:
            _check_temporal_pass(temporal, cfg.ny, self.device, exact, self.has_walls)
        self._a = self._b = None

    def load(self, f: DS) -> None:
        """Copy a DS pair into the session's buffers (allocated at the
        first load)."""
        if self._a is None:
            shape = (NSPEEDS, self.cfg.nx, self.cfg.ny)

            def buf():
                return torch.empty(shape, dtype=torch.float32, device=self.device)

            self._a, self._b = DS(buf(), buf()), DS(buf(), buf())
        self._a.hi.copy_(f.hi)
        self._a.lo.copy_(f.lo)

    def advance(self, n_steps: int) -> None:
        """n_steps steps: one launch per step, or passes of `temporal`
        steps and one of the rest; the two pairs swap after each launch."""
        a, b = self._a, self._b
        if self.temporal == 1:
            for _ in range(n_steps):
                step(a, b, self.solid, self.cfg, has_walls=self.has_walls, exact=self.exact)
                a, b = b, a
        else:
            full, rest = divmod(n_steps, self.temporal)
            for steps in [self.temporal] * full + ([rest] if rest else []):
                temporal_step(a, b, self.solid, self.cfg, steps, has_walls=self.has_walls,
                              exact=self.exact)
                a, b = b, a
        self._a, self._b = a, b

    def block(self) -> None:
        """Completion barrier for the launches so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def state(self) -> DS:
        """The current pair, copied (the session keeps its buffers)."""
        return DS(self._a.hi.clone(), self._a.lo.clone())

    def probe_sites(self, probes) -> torch.Tensor:
        """(P, 2) probe sites (i, j) as int64 on the session's device;
        raises as stream_collide.probe_sites."""
        return stream_collide.probe_sites(probes, self.cfg, self.device)

    def probe_values(self, sites: torch.Tensor) -> torch.Tensor:
        """(rho, u_x, u_y) in float64 at (P, 2) sites (probe_sites) of the live pair
        (ds_engine.probe_values): (P, 3). Copies nothing else of the
        state."""
        return ds_engine.probe_values(self._a, sites)

    def unload(self) -> DS:
        """The current pair; the session releases its buffers."""
        out, self._a, self._b = self._a, None, None
        return out


def run_steps(f: DS, walls, cfg: LatticeConfig, n_steps: int, exact: bool = False,
              temporal: int = DS_TEMPORAL) -> DS:
    """n_steps on f's device, unpadded in and out, through a Session:
    passes of `temporal` steps (the JAX run_steps' fusion depth) and one
    of the rest, or at temporal=1, at the exact tier and where NY is no
    multiple of 4 one launch per step (Session); bitwise the same at every
    temporal. `f` is not modified."""
    sess = Session(cfg, walls.cpu().numpy() if torch.is_tensor(walls) else walls,
                   device=f.hi.device, exact=exact, temporal=temporal)
    sess.load(f)
    sess.advance(n_steps)
    return sess.unload()
