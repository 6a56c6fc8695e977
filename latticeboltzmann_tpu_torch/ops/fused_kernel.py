"""The fused stream-collide kernel's runner surface: twin of the
Session / run_steps surface of latticeboltzmann_tpu/ops/fused_kernel.py.

One launch advances the whole lattice one step out of place: forcing at
column 0, periodic pull, BGK collision and the solid classes
(bounce-back, free-slip), in the JAX package's fused-kernel arithmetic
order. The `step` wrapper launches it for CUDA tensors and takes
`step_reference`, its plain PyTorch version, for CPU tensors; anything
else raises.

The single-chip kernel has two forms with one result (`kernel_form`
picks by storage type, row length and pointers, never by a failed
launch): the wide form (csrc/lbm_wide_step.cu; plain version
`step_reference_wide`), in which a thread owns WIDE_COLUMNS consecutive
columns and every access to device memory is a 16-byte vector, wherever
NY is a multiple of that count and the buffers are 16-byte aligned; and
the narrow form (csrc/lbm_step.cu), one site per thread, for every other
shape. Launches are counted by form in FORM_LAUNCHES.

Variants (the JAX kernel at T=1):
- storage: float32, or bfloat16 with float32 arithmetic;
- geometry: none (wall-free), a uint8 class plane (0 fluid, 1
  bounce-back, 2 slip_x, 3 slip_y; `class_plane`), or a closed-form wall
  spec evaluated in the kernel (no plane read; geometry.infer_spec);
- fast_math: an approximate 1/rho.

The ext-halo form (`ext_launcher`; plain version
`step_reference_ext`) is the same step on one shard of the row-sharded
path (parallel/sharded.py): a launch writes a range of the shard's local
rows, and the rows beyond the shard come from two halo rows, each with
all 9 speed planes of a ring neighbour's boundary row. Its launches are
counted apart, in EXT_LAUNCHES, EXT_VARIANT_LAUNCHES and, by form,
EXT_FORM_LAUNCHES.

The rdma form (`rdma_launcher`; plain version `step_reference_rdma`) is
the ext-halo step of a whole shard with the halo exchange inside the
kernel: one launch per shard and step sends the shard's two boundary rows
into its ring neighbours' comm buffers (`RdmaEnd`), computes the interior
rows, waits for the neighbours' rows and computes the edge rows; the host
makes no copy. `rdma_schedule` holds the protocol as plain constants. Its
launches are counted in RDMA_LAUNCHES, RDMA_VARIANT_LAUNCHES and, by
form, RDMA_FORM_LAUNCHES.

The ext-halo and rdma forms have a wide and a narrow form each too, picked
by the same rule over every buffer the kernel reads or writes by vectors:
the wide ones (csrc/lbm_wide_ext_step.cu; plain version
`step_reference_ext_wide`) and the narrow ones of csrc/lbm_step.cu.

The flat form (`make_flat_step`, `flat_step`; plain versions
`flat_reference` and, tile by tile, `flat_reference_blocked`;
csrc/lbm_flat_step.cu) runs an even number of wall-free steps in ONE
cooperative launch over a stacked (2, 9, NX, NY) ping-pong pair, in
place, up to `temporal` steps per pass through device memory, the steps
of a pass kept in shared memory (`flat_schedule` plans the passes;
`flat_tile` reads the tile the card's shared memory gives the kernel):
the twin of the JAX package's make_flat_step. Its launches are counted
in FLAT_LAUNCHES.

The temporal form (`temporal_step`; plain versions `temporal_reference`
and, tile by tile, `temporal_reference_blocked`;
csrc/lbm_temporal_step.cu) is the main path's temporal blocking, the JAX
kernel at temporal = T > 1 with walls: one launch runs a pass of L steps
from src to dst, the session's two distinct buffers, the steps of the
pass kept in shared memory in the flat kernel's tile with a solid class
per tile site (`temporal_info` reads the tile the card gives it and
the deepest pass it takes). `Session(temporal=T)` runs n steps as n //
T passes of T steps and one of n % T; on a card `Session()` runs T =
DEFAULT_TEMPORAL wherever the form takes the rows (`default_temporal`),
a rest of one step there through the one-step kernel.
Its launches are counted in TEMPORAL_LAUNCHES and
TEMPORAL_VARIANT_LAUNCHES, the steps they ran in TEMPORAL_STEPS.

A shard's passes of the row-sharded path have two forms of their own,
the temporal form's tile and levels on a shard whose rows beyond it come
from T-row halo blocks (csrc/lbm_temporal_step.cu, lbm_temporal.cuh):
the ext-halo temporal form (`ext_temporal_launcher`; plain versions
`temporal_reference_ext` and, tile by tile,
`temporal_reference_ext_blocked`), a pass of L <= T steps of a range of
a shard's rows from halos the host copied (each launch at the tile of
its own plan, `shard_tile_plan`, which `ext_temporal_plan` reads from the
card), counted in
EXT_TEMPORAL_LAUNCHES, EXT_TEMPORAL_VARIANT_LAUNCHES and
EXT_TEMPORAL_STEPS; and the rdma temporal form
(`rdma_temporal_launcher`; plain version `temporal_reference_rdma`, with
its send and compute halves; csrc/lbm_temporal_rdma_step.cu), a pass of a
whole shard that sends its T edge rows into its neighbours' comm blocks
(`rdma_end(..., depth=T)`, `rdma_temporal_schedule`) inside the kernel,
counted in RDMA_TEMPORAL_LAUNCHES, RDMA_TEMPORAL_VARIANT_LAUNCHES and
RDMA_TEMPORAL_STEPS.

State is the unpadded (9, NX, NY) layout: the TPU kernel's mirror-pad
lanes and VMEM staging have no counterpart here (ROADMAP, "Not to port").

A float64 config has no kernel (ROADMAP B15): `run_steps` and
`run_steps_probed` take it to the portable engine (ops/stream_collide.py)
on f's device, the form F64_FORM, counted in F64_STEPS, as the JAX
run_steps takes it to its XLA engine when its planner returns None. The
kernel entry points (`step`, `temporal_step`, the ext-halo and rdma
launchers) and `Session` raise NotImplementedError on it.

The probed run (`run_steps_probed`; Simulation.run_probed through
`Session.probe_values`) samples (rho, u_x, u_y) at probe sites from the
session's live buffer after every `every` launches into a series
preallocated on the device: the twin of the JAX _make_probed_runner,
without its choice of pass structure by every % (2T), which is TPU
scheduling. The sites need no remapping: the session does not pad.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import itertools
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..core import geometry
from ..core.spec import E, NSPEEDS, OPPOSITE, REFLECT_X, REFLECT_Y, W, LatticeConfig
from ..utils import profiler
from ..utils.interop import storage_dtype
from . import cuda_build, stream_collide

# kernel launches made by `step`, in all and by variant name
# (`variant_name`), for callers that must show a run went through the
# kernel (chip_smoke.py resets and reads both)
LAUNCHES = 0
VARIANT_LAUNCHES: collections.Counter = collections.Counter()
# the forms run_steps chooses by dtype (run_form): the portable engine
# for float64, which no kernel takes, and the kernel session; the steps
# run in the first, which no launch count includes
F64_FORM = "torch-f64"
KERNEL_FORM = "kernel"
F64_STEPS = 0
# the same launches by the single-chip kernel's form, "wide" or "narrow"
FORM_LAUNCHES: collections.Counter = collections.Counter()
# the same for the ext-halo form's launches (`ext_launcher`)
EXT_LAUNCHES = 0
EXT_VARIANT_LAUNCHES: collections.Counter = collections.Counter()
EXT_FORM_LAUNCHES: collections.Counter = collections.Counter()
# the same for the rdma form's launches (`rdma_launcher`)
RDMA_LAUNCHES = 0
RDMA_VARIANT_LAUNCHES: collections.Counter = collections.Counter()
RDMA_FORM_LAUNCHES: collections.Counter = collections.Counter()
# launches of the flat multi-step kernel (`flat_step`), each of which runs
# many steps
FLAT_LAUNCHES = 0
# the flat kernel: steps a pass keeps in shared memory by storage type
# (the temporal of the JAX make_flat_step), chosen by measurement
# (PERF.md); the most runs of equal passes a launch takes; the largest
# temporal the wrapper takes (on a card, a depth whose pass leaves no
# output tile in the card's tile is refused too)
FLAT_TEMPORAL = {torch.float32: 6, torch.bfloat16: 8}
# the depth Session(temporal=None) runs where the temporal form takes the
# rows on a card (default_temporal), by storage: by scripts/depth_sweep.py
# on an H100 the fastest of T = 1, 4-8 at 800x4000 and 4000x16000 in both
# storages, from rest and in a developed flow, or within 1% of it (T = 5
# in float32 at 4000x16000 from rest, at 800x4000 developed; PERF.md,
# section 6, the default depth)
DEFAULT_TEMPORAL = {torch.float32: 6, torch.bfloat16: 6}
FLAT_RUNS = 4
FLAT_MAX_TEMPORAL = 32
# launches of the temporal form (`temporal_step`), in all and by variant
# name, and the steps they ran
TEMPORAL_LAUNCHES = 0
TEMPORAL_VARIANT_LAUNCHES: collections.Counter = collections.Counter()
TEMPORAL_STEPS = 0
# the same for a shard's passes: the ext-halo temporal form
# (`ext_temporal_launcher`) and the rdma temporal form
# (`rdma_temporal_launcher`)
EXT_TEMPORAL_LAUNCHES = 0
EXT_TEMPORAL_VARIANT_LAUNCHES: collections.Counter = collections.Counter()
EXT_TEMPORAL_STEPS = 0
RDMA_TEMPORAL_LAUNCHES = 0
RDMA_TEMPORAL_VARIANT_LAUNCHES: collections.Counter = collections.Counter()
RDMA_TEMPORAL_STEPS = 0

# the storage and geometry codes of the launcher in csrc/lbm_step.cu
_STORAGE = {torch.float32: 0, torch.bfloat16: 1}
_GEOMETRY = {"none": 0, "plane": 1, "spec": 2}
# the wide form: columns per thread by storage type, one 16-byte vector
# (csrc/lbm_wide_step.cu restates them; lbm_wide_columns reads them back),
# and the alignment its vector accesses need of every buffer
WIDE_COLUMNS = {torch.float32: 4, torch.bfloat16: 8}
WIDE_ALIGN = 16
FORMS = ("wide", "narrow")
# solid-class codes: 0 fluid, 1 bounce-back, 2 slip_x, 3 slip_y
MAX_CODE = 3
# the int64 fields of a wall spec in the kernel's Spec order
SPEC_FIELDS = 10
# fast math has no bitwise reference: rcp.approx.f32 is within about one
# float32 ulp of 1/rho, so each step moves a value by a few ulps (~1e-7
# relative). The fast-math variant is held to step_reference (IEEE 1/rho)
# by the max relative difference after FAST_MATH_STEPS chained steps on
# each side; an H100 measured 1.18e-6 at 800x4000 (PERF.md).
FAST_MATH_RTOL = 1e-5
FAST_MATH_STEPS = 10

# the rdma form: how long an edge row waits for a neighbour's rows before
# its launch gives up (seconds)
RDMA_TIMEOUT_S = 2.0
# the int64 launch words of an rdma end: the one-step form's [ticket
# counter, error word]; the temporal form's [ticket counter, error word,
# CTAs finished, senders done up, senders done down, tiles handed out]
# (csrc/lbm_temporal_rdma_step.cu restates them; lbm_temporal_steps_rdma_words
# reads them back)
RDMA_WORDS = 2
RDMA_TEMPORAL_WORDS = 6
# the shard forms' tile plan (shard_tile_plan): ns per byte of a tile's
# traffic and per site update of its levels, by storage, on one SM of an
# H100 (PERF.md, PR 19; csrc/lbm_temporal.cuh restates them), and the CTAs
# of an rdma launch that send first (csrc/lbm_temporal_rdma_step.cu
# restates it)
TILE_NS_PER_BYTE = 0.0449
TILE_NS_PER_SITE = {torch.float32: 1.0, torch.bfloat16: 1.28}
RDMA_SENDERS = 8
# the temporal forms' tile columns, halos included (csrc/lbm_tile.cuh's kW)
TILE_WIDTH = 72

# solid planes whose codes were checked, by tensor: (version counter at
# the check, largest code). The check syncs with the device, so it runs
# once per plane and again only after an in-place write to it
_CHECKED_SOLID = WeakIdKeyDictionary()


@functools.lru_cache(maxsize=64)
def kernel_constants(cfg: LatticeConfig) -> tuple[float, ...]:
    """The kernel's launch constants, rounded to float32 the way the JAX
    fused kernel rounds them (ops/fused_kernel.py:424-434 there, then
    the folded products at :1041-1053): (c1, iw0, iw14, iw58, k3, k6,
    half, a14, a58), the order of Params in csrc/lbm_step.cu. Float32
    for every storage dtype. Cached: `step` reads them at every
    launch."""
    dt = np.float32
    one, three, half, sixth = dt(1.0), dt(3.0), dt(0.5), dt(1.0 / 6.0)
    csq, icsq, itau = dt(cfg.csq), dt(1.0 / cfg.csq), dt(1.0 / cfg.tau)
    w = [dt(W[s]) for s in range(NSPEEDS)]
    a14 = dt(cfg.accel) * dt(W[1])
    a58 = dt(cfg.accel) * dt(W[5])
    return tuple(
        float(x) for x in (one - itau, itau * w[0], itau * w[1], itau * w[5],
                           three * icsq, sixth * csq, half, a14, a58)
    )


def class_plane(walls, slip_x=None, slip_y=None) -> np.ndarray:
    """Solid-class codes as one (NX, NY) uint8 plane: 0 fluid, 1
    bounce-back wall, 2 slip_x, 3 slip_y. Precedence walls > slip_x >
    slip_y, as the JAX package's class_plane (ops/fused_kernel.py:
    1879-1889 there, which holds the same codes as float32)."""
    walls = np.asarray(walls, dtype=bool)
    cls = walls.astype(np.uint8)
    if slip_y is not None:
        cls[np.asarray(slip_y, dtype=bool) & ~walls] = 3
    if slip_x is not None:
        cls[np.asarray(slip_x, dtype=bool) & ~walls] = 2
    return cls


def kernel_spec(spec, nx: int, ny: int) -> tuple[int, ...]:
    """A wall spec as the kernel's Spec fields: (channel, rect, r0, r1,
    c0, c1, circle, ci2, cj2, r2q), int64. The kernel takes at most one
    ("channel",), one ("rect", r0, r1, c0, c1) and one ("circle2", ci2,
    cj2, r2q), which covers everything geometry.infer_spec returns;
    anything else raises ValueError, as does a circle2 whose integer test
    could overflow int64 on an nx x ny lattice."""
    out = [0] * SPEC_FIELDS
    seen = set()
    for prim in spec:
        kind = prim[0] if isinstance(prim, tuple) and prim else None
        shape = {"channel": 1, "rect": 5, "circle2": 4}.get(kind)
        if shape is None or kind in seen or len(prim) != shape:
            raise ValueError(
                f"the kernel takes at most one ('channel',), one ('rect', r0, r1, c0, c1) "
                f"and one ('circle2', ci2, cj2, r2q); got {spec!r}"
            )
        if not all(isinstance(v, (int, np.integer)) for v in prim[1:]):
            raise ValueError(f"wall-spec primitive {prim!r} must hold integers")
        seen.add(kind)
        vals = [int(v) for v in prim[1:]]
        if kind == "channel":
            out[0] = 1
        elif kind == "rect":
            out[1:6] = [1, *vals]
        else:
            out[6:10] = [1, *vals]
    if any(abs(v) >= 2**62 for v in out):
        raise ValueError(f"wall-spec values out of range: {spec!r}")
    if out[6]:
        di = max(abs(out[7]), abs(2 * (nx - 1) - out[7]))
        dj = max(abs(out[8]), abs(2 * (ny - 1) - out[8]))
        if di * di + dj * dj >= 2**63:
            raise ValueError(f"circle2 {spec!r} overflows int64 on a {nx}x{ny} lattice")
    return tuple(out)


def variant_name(dtype: torch.dtype, geometry_kind: str, slip: bool, fast_math: bool) -> str:
    """The key of VARIANT_LAUNCHES: storage-geometry[-slip][-fast], e.g.
    "f32-spec", "bf16-plane-slip", "f32-spec-fast"."""
    name = f"{'bf16' if dtype == torch.bfloat16 else 'f32'}-{geometry_kind}"
    return name + ("-slip" if slip else "") + ("-fast" if fast_math else "")


def collide_reference(pulled: torch.Tensor, cfg: LatticeConfig) -> torch.Tensor:
    """BGK collision in the fused kernel's association order: moments
    from the d56/d78/d58/d67 partial sums, relaxation folded into the
    weights, the quadratic term shared by each opposite pair."""
    c1, iw0, iw14, iw58, k3, k6, half, _, _ = kernel_constants(cfg)
    p = pulled
    d56 = p[5] + p[6]
    d78 = p[7] + p[8]
    d58 = p[5] + p[8]
    d67 = p[6] + p[7]
    density = (p[0] + (p[1] + p[3])) + ((p[2] + p[4]) + (d56 + d78))
    inv_rho = torch.ones((), dtype=p.dtype, device=p.device) / density
    u_x = ((p[2] - p[4]) + (d56 - d78)) * inv_rho
    u_y = ((p[1] - p[3]) + (d58 - d67)) * inv_rho
    ux3 = k3 * u_x
    uy3 = k3 * u_y
    base = 1.0 - k6 * (ux3 * ux3 + uy3 * uy3)
    r0, r14, r58 = iw0 * density, iw14 * density, iw58 * density
    out = [None] * NSPEEDS
    out[0] = c1 * p[0] + r0 * base
    for sp, sn, r, eu in ((1, 3, r14, uy3), (2, 4, r14, ux3),
                          (5, 7, r58, ux3 + uy3), (6, 8, r58, ux3 - uy3)):
        q = base + half * eu * eu
        out[sp] = c1 * p[sp] + r * (q + eu)
        out[sn] = c1 * p[sn] + r * (q - eu)
    return torch.stack(out)


@functools.lru_cache(maxsize=8)
def _spec_plane(spec: tuple, nx: int, ny: int, device: torch.device) -> torch.Tensor:
    """A wall spec as a read-only uint8 plane on `device`. Cached:
    geometry.spec_mask builds the mask on the host, which at 800x4000
    costs more than the step itself."""
    return torch.as_tensor(geometry.spec_mask(spec, nx, ny).astype(np.uint8), device=device)


def step_reference(
    src: torch.Tensor,
    solid: torch.Tensor | None,
    cfg: LatticeConfig,
    *,
    wall_spec=None,
    fast_math: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's one step: forcing, pull,
    collision in the fused order, then the solid classes (bounce-back
    with wall-f0 passthrough, the slip reflections). Returns a new
    tensor of src's dtype.

    solid: (NX, NY) uint8 codes (0 fluid, 1 bounce-back, 2 slip_x, 3
    slip_y); or wall_spec, a closed-form spec materialized through
    geometry.spec_mask; neither is the wall-free variant. Forcing skips
    every nonzero code.

    bfloat16 src is the JAX Pallas kernel at T=1: the exact upcast goes
    through the float32 step, whose forced column stays float32 through
    the pull (the XLA engine instead rounds it to bf16 first), and the
    result is rounded once, to nearest even.

    fast_math is taken for the kernel's signature and computes IEEE
    1/rho: the approximate reciprocal has no bitwise reference (the
    kernel's fast-math variant is held to this within FAST_MATH_RTOL)."""
    del fast_math
    if wall_spec is not None:
        if solid is not None:
            raise ValueError("give a solid plane or a wall spec, not both")
        solid = _spec_plane(tuple(map(tuple, wall_spec)), cfg.nx, cfg.ny, src.device)
    f = src.float() if src.dtype == torch.bfloat16 else src
    if solid is None:
        solid = torch.zeros(src.shape[1:], dtype=torch.uint8, device=src.device)
    pulled = stream_collide.pull(stream_collide.apply_source(f, solid != 0, cfg))
    return _collide_classes(pulled, solid, cfg).to(src.dtype)


def _collide_classes(pulled: torch.Tensor, solid: torch.Tensor,
                     cfg: LatticeConfig) -> torch.Tensor:
    """What follows the pull: the collision in the fused order, then the
    solid classes from the pulled values."""
    out = collide_reference(pulled, cfg)
    for code, table in ((2, REFLECT_X), (3, REFLECT_Y), (1, OPPOSITE)):
        out = torch.where((solid == code)[None], pulled[table.tolist()], out)
    return out


def step_reference_wide(
    src: torch.Tensor,
    geom: torch.Tensor | None,
    cfg: LatticeConfig,
    v: int,
    *,
    wall_spec=None,
) -> torch.Tensor:
    """Plain PyTorch version of the wide form: step_reference's result,
    with the pull assembled the way csrc/lbm_wide_step.cu assembles it.
    A thread owns `v` consecutive columns of a row, NY a multiple of v.
    Per speed it reads its own aligned v-column vector of the source row;
    the speeds with e_y = +1 shift it right by one and take the missing
    column from the left neighbour's vector (its last element; for the
    owner of columns [0, v) the wrap, column NY - 1), those with e_y = -1
    mirror it. The forcing is not a pass over column 0: the two owners
    whose pull reads column 0 (the first through its own element 0, into
    column 1; the last through the wrap, into column NY - 1) evaluate the
    guard of the source row and add the increment to the pulled value,
    which stays float32 under bf16 storage. geom: a uint8 class plane or
    None; or wall_spec. src may hold any number of rows (a shard's
    halo-extended block; the wall spec then does not apply). Must equal
    step_reference bit for bit."""
    nx, ny = src.shape[1], cfg.ny
    if not isinstance(v, int) or v < 2 or ny % v:
        raise ValueError(f"the wide form needs NY a multiple of v >= 2, got NY {ny}, v {v!r}")
    if wall_spec is not None:
        if geom is not None:
            raise ValueError("give a solid plane or a wall spec, not both")
        geom = _spec_plane(tuple(map(tuple, wall_spec)), cfg.nx, ny, src.device)
    f = src.float() if src.dtype == torch.bfloat16 else src
    solid = geom if geom is not None else torch.zeros((nx, ny), dtype=torch.uint8,
                                                      device=src.device)
    a14, a58 = kernel_constants(cfg)[7:]
    # the guard of each row's column-0 site, as forced_at evaluates it
    guard = ((solid[:, 0] == 0) & (f[6, :, 0] - a58 > 0) & (f[3, :, 0] - a14 > 0)
             & (f[7, :, 0] - a58 > 0))
    pulled = []
    for s in range(NSPEEDS):
        ex, ey = int(E[s, 0]), int(E[s, 1])
        # row i of `own`: each owner's vector of the source row i - e_x
        own = torch.roll(f[s], ex, 0).reshape(nx, ny // v, v)
        if ey == 0:
            pulled.append(own.reshape(nx, ny))
            continue
        forced = torch.roll(guard, ex, 0)  # the source row's guard
        a = a14 if s in (1, 3) else a58
        if ey == 1:
            lent = torch.roll(own[:, :, v - 1], 1, 1)  # owner 0: column NY - 1
            p = torch.cat([lent[:, :, None], own[:, :, :v - 1]], dim=2)
            p[:, 0, 1] = torch.where(forced, p[:, 0, 1] + a, p[:, 0, 1])
        else:
            lent = torch.roll(own[:, :, 0], -1, 1)  # the last owner: column 0
            p = torch.cat([own[:, :, 1:], lent[:, :, None]], dim=2)
            p[:, -1, v - 1] = torch.where(forced, p[:, -1, v - 1] + (-a), p[:, -1, v - 1])
        pulled.append(p.reshape(nx, ny))
    return _collide_classes(torch.stack(pulled), solid, cfg).to(src.dtype)


def check_solid(solid: torch.Tensor, max_code: int = MAX_CODE) -> int:
    """Raise unless every code is in 0..max_code; return the largest
    code. Syncs with the device, so it is memoized per plane."""
    memo = _CHECKED_SOLID.get(solid)
    if memo is None or memo[0] != solid._version:
        memo = (solid._version, int(solid.max()) if solid.numel() else 0)
        _CHECKED_SOLID[solid] = memo
    if memo[1] > max_code:
        raise ValueError(
            f"solid code {memo[1]} found; this kernel takes codes 0-{max_code} "
            "(0 fluid, 1 bounce-back, 2 slip_x, 3 slip_y)"
        )
    return memo[1]


def check_device(t: torch.Tensor) -> None:
    """Raise unless t lies on the CPU (where a wrapper takes the plain
    version) or on the current device of an available CUDA card."""
    if t.device.type == "cpu":
        return
    if t.device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"the kernel needs a CUDA tensor on an available card, got a tensor on {t.device}"
        )
    if t.get_device() != torch.cuda.current_device():
        raise ValueError(
            f"tensor on {t.device}, current device cuda:{torch.cuda.current_device()}"
        )


def check_solid_plane(solid, shape: tuple, device: torch.device,
                      max_code: int = MAX_CODE) -> int:
    """Raise unless solid is a contiguous uint8 (NX, NY) plane on
    `device` holding codes 0..max_code; return its largest code."""
    if not isinstance(solid, torch.Tensor):
        raise ValueError(f"the masked variant needs a uint8 solid plane, got {type(solid)}")
    if solid.dtype != torch.uint8 or tuple(solid.shape) != shape:
        raise ValueError(f"solid must be uint8 {shape}, got {solid.dtype} {tuple(solid.shape)}")
    if not solid.is_contiguous() or solid.device != device:
        raise ValueError("solid must be contiguous and on src's device")
    return check_solid(solid, max_code)


def _storage(cfg: LatticeConfig) -> torch.dtype:
    st = storage_dtype(cfg.dtype)
    if st not in _STORAGE:
        raise NotImplementedError(
            f"the stream-collide kernel takes float32 and bfloat16 storage; {st} is "
            "ROADMAP B15 (the f64 variant)"
        )
    return st


def _check(src, dst, geom, cfg: LatticeConfig) -> tuple[str, object]:
    """Validate a launch; return the geometry kind and what the launch
    needs of it (the plane's largest code, or the kernel's spec
    fields)."""
    st = _storage(cfg)
    check_device(src)
    shape = (NSPEEDS, cfg.nx, cfg.ny)
    if src is dst or src.data_ptr() == dst.data_ptr():
        raise ValueError("step is out of place: src and dst must be distinct buffers")
    for name, t in (("src", src), ("dst", dst)):
        if t.dtype != st:
            raise TypeError(f"{name} must be {st} (the config's storage), got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dst.device != src.device:
        raise ValueError(f"dst on {dst.device}, src on {src.device}")
    if geom is None:
        return "none", None
    if isinstance(geom, tuple):
        return "spec", kernel_spec(geom, cfg.nx, cfg.ny)
    return "plane", check_solid_plane(geom, shape[1:], src.device)


def kernel_form(dtype: torch.dtype, ny: int, pointers) -> str:
    """The form `step` launches for this storage type, row length and
    buffers: "wide" wherever the wide form can run, else "narrow". It can
    where it has a column count for the storage type, NY is a multiple of
    that count, and every buffer the kernel reads or writes by vectors
    (`pointers`: the data_ptr() of src, dst and, in the plane variant, the
    class plane) is aligned to WIDE_ALIGN bytes; a contiguous state that
    is a view into a larger buffer need not be. The wide form is the
    faster one for both storage types on an H100 (800x4000, in turns in
    one run: float32 85.90 against 90.01 us, bf16 45.60 against 68.44)."""
    v = WIDE_COLUMNS.get(dtype)
    wide = v is not None and ny % v == 0 and all(p % WIDE_ALIGN == 0 for p in pointers)
    return "wide" if wide else "narrow"


def _choose_form(form: str | None, dtype: torch.dtype, ny: int, pointers) -> str:
    """The form a launch takes: `form` as asked ("wide" or "narrow"), or
    for None kernel_form's choice. Raises ValueError for any other form,
    and for "wide" where kernel_form's rule does not hold: nothing else
    runs in its place."""
    if form is not None and form not in FORMS:
        raise ValueError(f"form must be one of {FORMS} or None, got {form!r}")
    rule = kernel_form(dtype, ny, pointers)
    if form == "wide" and rule != "wide":
        raise ValueError(
            f"the wide form needs NY a multiple of {WIDE_COLUMNS.get(dtype)} columns "
            f"({dtype}) and buffers aligned to {WIDE_ALIGN} bytes; got NY {ny}, "
            f"pointers mod {WIDE_ALIGN}: {[p % WIDE_ALIGN for p in pointers]}")
    return form or rule


def step(
    src: torch.Tensor,
    dst: torch.Tensor,
    geom,
    cfg: LatticeConfig,
    *,
    fast_math: bool = False,
    form: str | None = None,
) -> torch.Tensor:
    """One step src -> dst; returns dst. geom is None (the wall-free
    variant), a uint8 (NX, NY) class plane, or a wall spec tuple (the
    mask computed in the kernel). src and dst hold the config's storage
    dtype, float32 or bfloat16. On a CUDA tensor it launches the kernel
    on the current stream, in the form kernel_form names, and counts it
    in LAUNCHES, VARIANT_LAUNCHES and FORM_LAUNCHES; on a CPU tensor it
    writes step_reference's result. form="wide" or "narrow" asks for one
    form (on a CPU tensor, for its plain version): "wide" raises
    ValueError where the wide form does not apply, and never runs
    anything else in its place. Raises on anything the kernel does not
    take, and on any other device."""
    global LAUNCHES
    kind, info = _check(src, dst, geom, cfg)
    pointers = [src.data_ptr(), dst.data_ptr()] + ([geom.data_ptr()] if kind == "plane" else [])
    chosen = _choose_form(form, src.dtype, cfg.ny, pointers)
    if src.device.type == "cpu":
        plane, spec = (None, geom) if kind == "spec" else (geom, None)
        if form == "wide":
            dst.copy_(step_reference_wide(src, plane, cfg, WIDE_COLUMNS[src.dtype],
                                          wall_spec=spec))
        else:
            dst.copy_(step_reference(src, plane, cfg, wall_spec=spec))
        return dst
    form = chosen
    params = (ctypes.c_float * 9)(*kernel_constants(cfg))
    spec = (ctypes.c_int64 * SPEC_FIELDS)(*info) if kind == "spec" else None
    lib = cuda_build.load_library()
    launch = lib.lbm_stream_collide_wide_launch if form == "wide" else lib.lbm_stream_collide_launch
    rc = launch(
        src.data_ptr(), dst.data_ptr(),
        geom.data_ptr() if kind == "plane" else None,
        ctypes.addressof(spec) if spec is not None else None,
        cfg.nx, cfg.ny, _STORAGE[src.dtype], _GEOMETRY[kind], int(fast_math),
        ctypes.addressof(params), torch.cuda.current_stream(src.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"lbm_stream_collide launch ({form} form) failed: cudaError {rc}")
    LAUNCHES += 1
    VARIANT_LAUNCHES[variant_name(src.dtype, kind, kind == "plane" and info > 1,
                                  fast_math)] += 1
    FORM_LAUNCHES[form] += 1
    return dst


class ShardPlane(NamedTuple):
    """The class-plane geometry of one shard for the ext-halo form: its
    (L, NY) uint8 class plane and the (NY,) class rows of its two halo
    rows, the neighbours' boundary rows."""

    plane: torch.Tensor
    top: torch.Tensor
    bot: torch.Tensor


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _spec_rows(spec, cfg: LatticeConfig, row_offset: int, n: int,
               device: torch.device) -> torch.Tensor:
    """Rows row_offset .. row_offset + n - 1 of a wall spec's mask, as
    uint8, periodic in the global row count cfg.nx."""
    rows = torch.arange(row_offset, row_offset + n) % cfg.nx
    return _spec_plane(tuple(map(tuple, spec)), cfg.nx, cfg.ny, device)[rows.to(device)]


def step_reference_ext(
    src: torch.Tensor,
    halo: tuple[torch.Tensor, torch.Tensor],
    geom,
    cfg: LatticeConfig,
    *,
    row_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the ext-halo form on a whole shard:
    step_reference on the halo-extended block (top, src, bot) with its
    class rows, then the shard's L rows. Returns a (9, L, NY) tensor of
    src's dtype.

    src: the shard's (9, L, NY) block, local row 0 at global row
    row_offset of a cfg.nx-row lattice; halo: (top, bot), the (9, NY)
    rows above and below it. geom: None, a ShardPlane, or a wall spec,
    evaluated at the global rows row_offset - 1 .. row_offset + L,
    periodic in cfg.nx. It computes IEEE 1/rho: the kernel's fast-math
    variant is held to it within FAST_MATH_RTOL."""
    block, solid = _ext_block(src, halo, geom, cfg, row_offset)
    return step_reference(block, solid, cfg)[:, 1:-1]


def _ext_block(src, halo, geom, cfg: LatticeConfig, row_offset: int):
    """The halo-extended (9, L + 2, NY) block (top, src, bot) and its
    uint8 class rows (None for the wall-free variant; a wall spec taken at
    the global rows row_offset - 1 .. row_offset + L, periodic in
    cfg.nx)."""
    top, bot = halo
    n = src.shape[1] + 2
    block = torch.cat([top[:, None], src, bot[:, None]], dim=1)
    if geom is None:
        solid = None
    elif isinstance(geom, ShardPlane):
        solid = torch.cat([geom.top[None], geom.plane, geom.bot[None]])
    else:
        solid = _spec_rows(geom, cfg, row_offset - 1, n, src.device)
    return block, solid


def step_reference_ext_wide(
    src: torch.Tensor,
    halo: tuple[torch.Tensor, torch.Tensor],
    geom,
    cfg: LatticeConfig,
    v: int,
    *,
    row_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the wide ext-halo and rdma forms
    (csrc/lbm_wide_ext_step.cu): step_reference_wide, the pull assembled
    from v-column vectors, neighbour elements and wrap loads with the
    forcing guard in the two owners that pull from column 0, on the
    halo-extended block with its class rows (the halo rows' own guards
    and classes; the wall spec at global rows), then the shard's L rows.
    The arguments of step_reference_ext, and v, the columns per thread.
    Must equal step_reference_ext bit for bit."""
    block, solid = _ext_block(src, halo, geom, cfg, row_offset)
    return step_reference_wide(block, solid, cfg, v)[:, 1:-1]


def check_ext_launch(blocks, halo, dtype: torch.dtype, cfg: LatticeConfig, row0: int,
                     rows: int, halo_rows: bool = True) -> int:
    """The checks of an ext-halo launch that do not depend on its kernel.
    blocks: (name, tensor) pairs, the first a source: contiguous (9, L,
    NY) blocks of `dtype` on the first one's device, a CPU tensor or the
    current card. The row range [row0, row0 + rows) lies in the shard. A
    range that writes row 0 or L - 1 needs halo = (top, bot), each side a
    (9, NY) row or a tuple of them (a pair's components), contiguous, of
    `dtype`, on that device (halo_rows=False: the caller checks its
    halos). Returns L."""
    name0, src = blocks[0]
    check_device(src)
    n_rows = src.shape[1] if src.dim() == 3 else -1
    shape = (NSPEEDS, n_rows, cfg.ny)
    for name, t in blocks:
        if t.dtype != dtype or tuple(t.shape) != shape or n_rows < 1:
            raise ValueError(f"{name} must be {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != src.device:
            raise ValueError(f"{name} must be contiguous and on {name0}'s device")
    if not (0 <= row0 and rows >= 1 and row0 + rows <= n_rows):
        raise ValueError(f"rows [{row0}, {row0 + rows}) outside the shard's {n_rows} rows")
    if halo_rows and (row0 == 0 or row0 + rows == n_rows):
        if halo is None or len(halo) != 2:
            raise ValueError("a launch that writes an edge row needs the (top, bot) halo rows")
        for t in (t for side in halo for t in ((side,) if torch.is_tensor(side) else side)):
            if (t.dtype != dtype or tuple(t.shape) != (NSPEEDS, cfg.ny) or not t.is_contiguous()
                    or t.device != src.device):
                raise ValueError(f"halo rows must be contiguous {dtype} {(NSPEEDS, cfg.ny)} on "
                                 f"{name0}'s device, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return n_rows


def _check_ext(src, dst, halo, geom, cfg: LatticeConfig, row0: int, rows: int,
               row_offset: int) -> tuple[str, object]:
    """Validate an ext-halo launch; return the geometry kind and what the
    launch needs of it (the largest class code, or the spec fields)."""
    n_rows = check_ext_launch((("src", src), ("dst", dst)), halo, _storage(cfg), cfg, row0, rows)
    if src.data_ptr() == dst.data_ptr():
        raise ValueError("step is out of place: src and dst must be distinct buffers")
    if not 0 <= row_offset <= cfg.nx - n_rows:
        raise ValueError(f"a {n_rows}-row shard at global row {row_offset} lies outside "
                         f"the {cfg.nx}-row lattice")
    if geom is None:
        return "none", None
    if isinstance(geom, ShardPlane):
        code = check_solid_plane(geom.plane, (n_rows, cfg.ny), src.device)
        for t in (geom.top, geom.bot):
            code = max(code, check_solid_plane(t[None], (1, cfg.ny), src.device))
        return "plane", code
    if isinstance(geom, tuple):
        return "spec", kernel_spec(geom, cfg.nx, cfg.ny)
    raise ValueError(f"the ext-halo form takes None, a ShardPlane or a wall spec, got {type(geom)}")


def ext_launcher(
    src: torch.Tensor,
    dst: torch.Tensor,
    halo,
    geom,
    cfg: LatticeConfig,
    *,
    row0: int = 0,
    rows: int | None = None,
    row_offset: int = 0,
    fast_math: bool = False,
    form: str | None = None,
) -> Callable[[], None]:
    """Validate one ext-halo launch and return it as a call with no
    arguments, to be made any number of times: it steps the local rows
    [row0, row0 + rows) (default: all) of the shard src -> dst from the
    buffers' contents at that time.

    src, dst: the shard's (9, L, NY) blocks of the storage dtype, local
    row 0 at global row row_offset of the cfg.nx-row lattice. halo: (top,
    bot), the (9, NY) rows above and below the shard, all 9 speed planes
    of each; needed only when the range touches row 0 or L - 1 (else
    None). geom: None, a ShardPlane (class plane and halo class rows), or
    a wall spec (evaluated at global rows). On CUDA tensors the call
    launches the kernel on the current stream, in the form kernel_form
    names for every buffer the wide form reads or writes by vectors (src,
    dst, the halo rows, the class plane; the halo class rows are read a
    byte at a time, in the forcing guard), or for a launch of one row the
    narrow form, and
    counts it in EXT_LAUNCHES, EXT_VARIANT_LAUNCHES and EXT_FORM_LAUNCHES;
    on CPU tensors it writes step_reference_ext's rows. form="wide" or
    "narrow" asks for one form (on CPU tensors, for its plain version:
    step_reference_ext_wide or step_reference_ext); "wide" raises
    ValueError where the wide form does not apply, and never runs anything
    else in its place. Raises on anything the kernel does not take. The
    call's `form` attribute names the form it launches (on CPU tensors:
    the form a card would launch)."""
    rows = src.shape[1] - row0 if rows is None else rows
    kind, info = _check_ext(src, dst, halo, geom, cfg, row0, rows, row_offset)
    plane = geom if kind == "plane" else ShardPlane(None, None, None)
    top, bot = halo if halo is not None else (None, None)
    # a launch of one row is latency-bound, and the narrow form spreads it
    # over a thread per site: the wide form's 4 or 8 sites per thread ran
    # the overlap schedule's one-row launches slower on an H100 (PERF.md)
    chosen = _choose_form(form or ("narrow" if rows == 1 else None), src.dtype, cfg.ny, [
        t.data_ptr() for t in (src, dst, top, bot, plane.plane) if t is not None])
    if src.device.type == "cpu":
        def reference():
            h = halo if halo is not None else (torch.zeros_like(src[:, 0]),) * 2
            out = (step_reference_ext_wide(src, h, geom, cfg, WIDE_COLUMNS[src.dtype],
                                           row_offset=row_offset) if form == "wide" else
                   step_reference_ext(src, h, geom, cfg, row_offset=row_offset))
            dst[:, row0:row0 + rows].copy_(out[:, row0:row0 + rows])

        reference.form = chosen
        return reference

    # host arrays the launch reads: kept alive by the closure
    params = (ctypes.c_float * 9)(*kernel_constants(cfg))
    spec = (ctypes.c_int64 * SPEC_FIELDS)(*info) if kind == "spec" else None
    form = chosen
    lib = cuda_build.load_library()
    fn = (lib.lbm_stream_collide_ext_wide_launch if form == "wide"
          else lib.lbm_stream_collide_ext_launch)
    args = (_ptr(src), _ptr(dst), _ptr(top), _ptr(bot), _ptr(plane.plane), _ptr(plane.top),
            _ptr(plane.bot), ctypes.addressof(spec) if spec is not None else None,
            src.shape[1], cfg.ny, row0, rows, row_offset, cfg.nx, _STORAGE[src.dtype],
            _GEOMETRY[kind], int(fast_math), ctypes.addressof(params))
    variant = variant_name(src.dtype, kind, kind == "plane" and info > 1, fast_math)
    device = src.device

    def launch():
        global EXT_LAUNCHES
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"lbm_stream_collide ext-halo launch ({form} form) failed: "
                               f"cudaError {rc}")
        EXT_LAUNCHES += 1
        EXT_VARIANT_LAUNCHES[variant] += 1
        EXT_FORM_LAUNCHES[form] += 1

    launch.host_args = (params, spec)  # alive as long as the call
    launch.form = form
    return launch


def rdma_schedule(rows: int, step: int) -> dict:
    """The schedule of the in-kernel halo exchange (the rdma form) as plain
    Python constants, the twin of the JAX package's rdma_schedule
    (ops/fused_kernel.py:137-179 there): which of a `rows`-row shard's rows
    go to whom, into which comm-buffer parity, which flag value the edge
    rows of step `step` (1, 2, ... since the flags were zeroed) wait for.
    Shard k's ring neighbours are shards (k + up) % n and (k + down) % n.
    A launch sends first, computes the interior rows [1, rows - 1), which
    read no comm row and wait for nothing, and last the edge rows 0 and
    rows - 1, once its top / bot flag holds at least `flag`. The kernel
    (csrc/lbm_step.cu) restates this; its plain version and the host replay
    of the tests read it from here.

    Two parities and monotonic flag values are all the reuse discipline the
    comm buffers need (the JAX kernel's pass-start barrier): a neighbour is
    at most one step ahead, because its step t + 1 edge rows wait for this
    shard's step t + 1 send, which comes after this shard's whole step t.
    So parity t % 2 is overwritten (at step t + 2) only after this shard
    read it at step t, and a flag read at step t holds t or t + 1."""
    return dict(
        parity=step % 2,
        flag=step,
        up=-1,
        down=+1,
        send_up_row=0,            # -> the upper neighbour's bot[parity], then its bot flag
        send_down_row=rows - 1,   # -> the lower neighbour's top[parity], then its top flag
        top_flag=0,               # index of the flag word that guards top[parity]
        bot_flag=1,
    )


class RdmaEnd(NamedTuple):
    """One shard's receiving end of the in-kernel halo exchange, on the
    shard's device: the comm rows its neighbours write (by step or pass
    parity, all 9 speed planes of each row), the flag words they then set,
    and the shard's own launch words. The one-step form's end holds one row
    a side; the temporal form's (rdma_end(..., depth=T)) T rows a side."""

    top: torch.Tensor    # (2, 9, NY) storage dtype: the row above local row 0
                         # (temporal form: (2, 9, T, NY), the T rows above it)
    bot: torch.Tensor    # (2, 9, NY): the row below the last local row (or T rows)
    flags: torch.Tensor  # (2,) int64, [top, bot]: the step (pass) whose rows they hold
    work: torch.Tensor   # (RDMA_WORDS,) int64, [ticket counter, error word]
                         # (temporal form: (RDMA_TEMPORAL_WORDS,))


def rdma_end(cfg: LatticeConfig, device, depth: int | None = None) -> RdmaEnd:
    """A zeroed RdmaEnd for a shard of a cfg.ny-column lattice on
    `device`: the one-step form's, or with `depth` the temporal form's,
    whose comm blocks hold `depth` rows a side (a pass of up to `depth`
    steps)."""
    if depth is None:
        shape, n_words = (2, NSPEEDS, cfg.ny), RDMA_WORDS
    else:
        if not isinstance(depth, int) or isinstance(depth, bool) or depth < 1:
            raise ValueError(f"depth must be a positive integer, got {depth!r}")
        shape, n_words = (2, NSPEEDS, depth, cfg.ny), RDMA_TEMPORAL_WORDS
    rows = torch.zeros(shape, dtype=_storage(cfg), device=device)
    words = torch.zeros(n_words, dtype=torch.int64, device=device)
    return RdmaEnd(rows, torch.zeros_like(rows), torch.zeros(2, dtype=torch.int64, device=device),
                   words)


def rdma_reset(end: RdmaEnd) -> None:
    """Zero an end's flags and launch words: the next step is step 1."""
    end.flags.zero_()
    end.work.zero_()


def rdma_timed_out(end: RdmaEnd) -> int:
    """The step at which an edge row of this end's shard gave up waiting
    for a neighbour's rows, or 0. Syncs with the device."""
    return int(end.work[1])


def rdma_send_reference(src: torch.Tensor, up: RdmaEnd, down: RdmaEnd, step: int) -> None:
    """Plain PyTorch version of a launch's send role: the shard's boundary
    rows into its neighbours' comm buffers, then their flags, by
    rdma_schedule."""
    s = rdma_schedule(src.shape[1], step)
    up.bot[s["parity"]].copy_(src[:, s["send_up_row"]])
    up.flags[s["bot_flag"]] = s["flag"]
    down.top[s["parity"]].copy_(src[:, s["send_down_row"]])
    down.flags[s["top_flag"]] = s["flag"]


def rdma_compute_reference(src: torch.Tensor, end: RdmaEnd, geom, cfg: LatticeConfig,
                           step: int, *, row_offset: int = 0,
                           form: str | None = None) -> torch.Tensor:
    """Plain PyTorch version of a launch's interior and edge roles:
    step_reference_ext (form="wide": step_reference_ext_wide, the wide
    kernel's) from the comm rows of this step's parity. Raises
    RuntimeError where the kernel's edge rows would wait in vain: a flag
    below this step's value."""
    s = rdma_schedule(src.shape[1], step)
    if int(end.flags.min()) < s["flag"]:
        raise RuntimeError(f"step {step}: a neighbour's rows have not arrived "
                           f"(flags {end.flags.tolist()})")
    halo = (end.top[s["parity"]], end.bot[s["parity"]])
    if form == "wide":
        return step_reference_ext_wide(src, halo, geom, cfg, WIDE_COLUMNS[src.dtype],
                                       row_offset=row_offset)
    return step_reference_ext(src, halo, geom, cfg, row_offset=row_offset)


def step_reference_rdma(srcs, ends, geoms, cfg: LatticeConfig, step: int) -> list[torch.Tensor]:
    """Plain PyTorch version of one step of the rdma form over a whole
    ring: every shard sends (rdma_send_reference), then every shard steps
    from what it received (rdma_compute_reference). srcs: the shards' (9,
    L, NY) blocks in row order; ends: their RdmaEnds, which this writes;
    geoms: each shard's None, ShardPlane or wall spec. Returns the shards'
    new blocks."""
    n, L = len(srcs), srcs[0].shape[1]
    s = rdma_schedule(L, step)
    for k, src in enumerate(srcs):
        rdma_send_reference(src, ends[(k + s["up"]) % n], ends[(k + s["down"]) % n], step)
    return [rdma_compute_reference(src, ends[k], geoms[k], cfg, step, row_offset=k * L)
            for k, src in enumerate(srcs)]


def _check_rdma_end(name: str, end: RdmaEnd, dtype: torch.dtype, ny: int,
                    device_type: str, depth: int | None = None) -> None:
    """Raise unless `end` is the one-step form's end (depth None) or the
    temporal form's of `depth` rows a side, of `dtype`, on one device of
    type device_type."""
    shape = (2, NSPEEDS, ny) if depth is None else (2, NSPEEDS, depth, ny)
    n_words = RDMA_WORDS if depth is None else RDMA_TEMPORAL_WORDS
    for rows in (end.top, end.bot):
        if (rows.dtype != dtype or tuple(rows.shape) != shape
                or not rows.is_contiguous() or rows.device != end.top.device):
            raise ValueError(f"{name}: comm rows must be contiguous {dtype} {shape} "
                             f"on one device, got {rows.dtype} {tuple(rows.shape)}")
    for words, n in ((end.flags, 2), (end.work, n_words)):
        if (words.dtype != torch.int64 or tuple(words.shape) != (n,)
                or not words.is_contiguous() or words.device != end.top.device):
            raise ValueError(f"{name}: flags and work must be int64 (2,) and ({n_words},) on "
                             "the comm rows' device")
    if end.top.device.type != device_type:
        raise ValueError(f"{name} lies on {end.top.device}, the shard on a {device_type} device")


def rdma_launcher(
    src: torch.Tensor,
    dst: torch.Tensor,
    end: RdmaEnd,
    up: RdmaEnd,
    down: RdmaEnd,
    geom,
    cfg: LatticeConfig,
    *,
    row_offset: int = 0,
    fast_math: bool = False,
    timeout_s: float = RDMA_TIMEOUT_S,
    stream=None,
    form: str | None = None,
) -> Callable[[int], None]:
    """Validate one shard's rdma launch and return it as a call launch(step),
    to be made once per step with step = 1, 2, ... since rdma_reset: it
    sends the shard's boundary rows to its neighbours' ends, steps the whole
    shard src -> dst from the buffers' contents at that time, its edge rows
    after the neighbours' rows of the same step arrived in `end`.

    src, dst: the shard's (9, L, NY) blocks, L >= 3, local row 0 at global
    row row_offset. end: the shard's own RdmaEnd; up, down: its ring
    neighbours' (the shard itself on a ring of one), which may lie on other
    cards that this card can address (lbm_enable_peer_access). geom: None, a
    ShardPlane or a wall spec, as ext_launcher's. Every shard of the ring
    must make the same call, on CUDA each on a stream of its own (`stream`,
    default: the current one at the call), or the edge rows give up after
    timeout_s and leave the step in end.work[1] (rdma_timed_out).

    On CUDA tensors the call launches the kernel, in the form kernel_form
    names for every buffer the wide form reads or writes by vectors (src,
    dst, end's comm rows, up.bot, down.top, the class plane), and counts
    it in RDMA_LAUNCHES, RDMA_VARIANT_LAUNCHES and
    RDMA_FORM_LAUNCHES. On CPU tensors it is the plain version in two
    halves, launch.send(step) and launch.compute(step): a ring calls every
    shard's send before any compute (launch(step) runs both, which
    suffices on a ring of one). form, and the call's `form` attribute, as
    ext_launcher's. Raises on anything the kernel does not take."""
    L = src.shape[1] if src.dim() == 3 else -1
    kind, info = _check_ext(src, dst, (end.top[0], end.bot[0]), geom, cfg, 0, L, row_offset)
    if L < 3:
        raise ValueError(f"the rdma form needs a shard of at least 3 rows, got {L}")
    for name, e in (("end", end), ("up", up), ("down", down)):
        _check_rdma_end(name, e, src.dtype, cfg.ny, src.device.type)
    if end.top.device != src.device:
        raise ValueError(f"end lies on {end.top.device}, the shard on {src.device}")
    plane = geom if kind == "plane" else ShardPlane(None, None, None)
    chosen = _choose_form(form, src.dtype, cfg.ny, [
        t.data_ptr() for t in (src, dst, end.top, end.bot, up.bot, down.top, plane.plane)
        if t is not None])
    if src.device.type == "cpu":
        def send(step: int) -> None:
            rdma_send_reference(src, up, down, step)

        def compute(step: int) -> None:
            dst.copy_(rdma_compute_reference(src, end, geom, cfg, step, row_offset=row_offset,
                                             form=form))

        def reference(step: int) -> None:
            send(step)
            compute(step)

        reference.send, reference.compute = send, compute
        reference.form = chosen
        return reference

    # host arrays the launch reads: kept alive by the closure
    params = (ctypes.c_float * 9)(*kernel_constants(cfg))
    spec = (ctypes.c_int64 * SPEC_FIELDS)(*info) if kind == "spec" else None
    form = chosen
    lib = cuda_build.load_library()
    fn = (lib.lbm_stream_collide_rdma_wide_launch if form == "wide"
          else lib.lbm_stream_collide_rdma_launch)
    flag = rdma_schedule(L, 1)
    args = (_ptr(src), _ptr(dst), _ptr(end.top), _ptr(end.bot), _ptr(up.bot), _ptr(down.top),
            _ptr(end.flags), _ptr(up.flags[flag["bot_flag"]:]), _ptr(down.flags[flag["top_flag"]:]),
            _ptr(end.work), _ptr(plane.plane), _ptr(plane.top), _ptr(plane.bot),
            ctypes.addressof(spec) if spec is not None else None,
            L, cfg.ny, row_offset, cfg.nx, _STORAGE[src.dtype], _GEOMETRY[kind], int(fast_math),
            ctypes.addressof(params))
    variant = variant_name(src.dtype, kind, kind == "plane" and info > 1, fast_math)
    device, timeout_ns = src.device, int(timeout_s * 1e9)
    handle = None if stream is None else stream.cuda_stream

    def launch(step: int) -> None:
        global RDMA_LAUNCHES
        st = torch.cuda.current_stream(device).cuda_stream if handle is None else handle
        rc = fn(*args, step, timeout_ns, st)
        if rc != 0:
            raise RuntimeError(f"lbm_stream_collide rdma launch ({form} form) failed: "
                               f"cudaError {rc}")
        RDMA_LAUNCHES += 1
        RDMA_VARIANT_LAUNCHES[variant] += 1
        RDMA_FORM_LAUNCHES[form] += 1

    # what the launch addresses, alive as long as the call
    launch.host_args = (params, spec, src, dst, end, up, down, geom)
    launch.form = form
    return launch


def enable_peer_access(device: torch.device, peer: torch.device) -> None:
    """Let kernels on the card `device` address the memory of the card
    `peer` (an rdma launch writes its neighbours' RdmaEnds); raises
    RuntimeError where the cards cannot reach each other."""
    if device == peer:
        return
    rc = cuda_build.load_library().lbm_enable_peer_access(device.index, peer.index)
    if rc != 0:
        raise RuntimeError(f"{device} cannot address the memory of {peer} (cudaError {rc}): "
                           "the rdma form needs peer access between neighbouring shards' cards")


def flat_reference(f2: torch.Tensor, cfg: LatticeConfig, n_steps: int) -> torch.Tensor:
    """Plain PyTorch version of the flat kernel: n_steps chained
    step_reference(src, None, cfg) from f2[0]. Returns a new stacked (2,
    9, NX, NY) tensor as the kernel leaves its buffer: the state after
    n_steps steps at parity 0, the state one step earlier at parity 1.
    bfloat16 rounds to storage after every step."""
    cur = prev = f2[0]
    for _ in range(n_steps):
        prev, cur = cur, step_reference(cur, None, cfg)
    return torch.stack([cur, prev])


class FlatTile(NamedTuple):
    """A tile of the flat kernel in shared memory: `rows` x `width` sites,
    from which a pass of L steps writes output tiles of flat_output(tile,
    dtype, L) sites (its halos, L rows and L columns rounded up to a
    16-byte vector, around them)."""

    rows: int
    width: int


def flat_output(tile: FlatTile, dtype: torch.dtype, steps: int) -> tuple[int, int]:
    """Rows and columns of the output tiles of a pass of `steps` steps."""
    v = WIDE_COLUMNS[dtype]
    return tile.rows - 2 * steps, tile.width - 2 * (-(-steps // v) * v)


def flat_info(dtype: torch.dtype, device=None) -> dict:
    """What a card gives the flat kernel for storage `dtype`, as
    csrc/lbm_flat_step.cu decides it from the card's shared memory: the
    tile's `rows` and `width`, `registers` and `local_bytes` (stack and
    spills) per thread, `ctas_per_sm` and `shared_bytes_per_cta`. Needs
    a CUDA card (default: the current one); read once per card."""
    index = None if device is None else torch.device(device).index
    return _flat_info(_STORAGE[dtype], torch.cuda.current_device() if index is None else index)


@functools.cache
def _flat_info(storage: int, index: int) -> dict:
    out = (ctypes.c_int64 * 6)()
    with torch.cuda.device(index):
        rc = cuda_build.load_library().lbm_flat_steps_info(storage, out)
    if rc != 0:
        raise RuntimeError(f"lbm_flat_steps_info failed: cudaError {rc}")
    return {"registers": out[0], "ctas_per_sm": out[1], "shared_bytes_per_cta": out[2],
            "local_bytes": out[3], "rows": out[4], "width": out[5]}


def flat_tile(dtype: torch.dtype, device=None) -> FlatTile:
    """The flat kernel's tile for storage `dtype` on a card (flat_info)."""
    info = flat_info(dtype, device)
    return FlatTile(info["rows"], info["width"])


def flat_schedule(n_steps: int, temporal: int) -> tuple[int, ...]:
    """The flat kernel's passes: the steps of each, in order. Passes of at
    most `temporal` steps, odd in number and as even as they go, cover
    the first n_steps - 1 steps, so that they end at parity 1 (one step
    earlier); a last pass of one step writes parity 0. A pass cannot also
    write its own source parity: other CTAs still read halos from it."""
    _check_flat_count(n_steps)
    _check_temporal(temporal)
    m = n_steps - 1
    k = -(-m // temporal)
    k += 1 - k % 2
    q, r = divmod(m, k)
    return (q + 1,) * r + (q,) * (k - r) + (1,)


def _flat_runs(plan: tuple[int, ...]) -> tuple[int, ...]:
    """A pass plan as the kernel takes it: the steps of each run of equal
    passes, then each run's count, FLAT_RUNS runs (zeros after the
    last)."""
    runs = [[n, len(list(g))] for n, g in itertools.groupby(plan)]
    if len(runs) > FLAT_RUNS:
        raise ValueError(f"a pass plan of more than {FLAT_RUNS} runs: {plan}")
    runs += [[0, 0]] * (FLAT_RUNS - len(runs))
    return tuple(n for n, _ in runs) + tuple(c for _, c in runs)


def flat_reference_blocked(f2: torch.Tensor, cfg: LatticeConfig, n_steps: int, temporal: int,
                           tile: FlatTile) -> torch.Tensor:
    """Plain PyTorch version of the flat kernel's tiling: flat_reference's
    result, computed the way csrc/lbm_flat_step.cu computes it. The pass
    plan is flat_schedule(n_steps, temporal); a pass of L steps reads one
    parity and writes the other, tile by tile: output tiles of
    flat_output(tile, dtype, L) sites (ragged at the last row and column),
    each from its source grown by L on each side with periodic wrap by
    modulo indices (a site may appear more than once), L levels each one
    site smaller on each side, the forcing at sources of GLOBAL column 0
    with the guard read at the level being read, and bfloat16 rounded to
    storage after every level. tile: any rows and width that leave an
    output tile (flat_tile gives the kernel's on a card). Returns a new
    stacked tensor."""
    _check_flat_count(n_steps)
    _check_temporal(temporal)
    tile = FlatTile(*tile)
    if min(flat_output(tile, f2.dtype, temporal)) < 1:
        raise ValueError(f"tile {tile} leaves no output tile at temporal={temporal}")
    out = f2.clone()
    solid = _solid_plane(None, cfg, f2.device)
    parity = 0
    for L in flat_schedule(n_steps, temporal):
        _blocked_pass(out[parity], out[parity ^ 1], solid, cfg, L, tile)
        parity ^= 1
    return out


def _solid_plane(geom, cfg: LatticeConfig, device: torch.device) -> torch.Tensor:
    """A geometry source of the step kernels as a uint8 (NX, NY) class
    plane on `device`: zeros for None, a wall spec's mask, or the plane."""
    if geom is None:
        return torch.zeros((cfg.nx, cfg.ny), dtype=torch.uint8, device=device)
    if isinstance(geom, tuple):
        return _spec_plane(tuple(map(tuple, geom)), cfg.nx, cfg.ny, device)
    return geom


def _blocked_pass(src: torch.Tensor, dst: torch.Tensor, solid: torch.Tensor,
                  cfg: LatticeConfig, L: int, tile: FlatTile, n_rows: int | None = None,
                  source_rows=None) -> None:
    """One pass of L steps src -> dst tile by tile, as the flat and
    temporal kernels run it: output tiles of flat_output(tile, dtype, L)
    sites over n_rows output rows (default cfg.nx), ragged at the last row
    and column; the tile of output rows [r0, r0 + re) reads the rows
    source_rows(r0, re) of src and solid (default: r0 - L .. r0 + re + L -
    1, periodic in cfg.nx)."""
    R, C = flat_output(tile, src.dtype, L)
    n_rows = cfg.nx if n_rows is None else n_rows
    if source_rows is None:
        def source_rows(r0, re):
            return torch.arange(r0 - L, r0 + re + L) % cfg.nx
    for r0 in range(0, n_rows, R):
        re = min(R, n_rows - r0)
        rows = source_rows(r0, re).to(src.device)
        for c0 in range(0, cfg.ny, C):
            ce = min(C, cfg.ny - c0)
            dst[:, r0:r0 + re, c0:c0 + ce] = _tile_pass(src, solid, cfg, rows, c0, ce, L)


def _tile_pass(src: torch.Tensor, solid: torch.Tensor, cfg: LatticeConfig, rows: torch.Tensor,
               c0: int, ce: int, L: int) -> torch.Tensor:
    """L levels of one tile: the len(rows) - 2 L x ce output sites at
    column c0 after L steps from src, through a source window of the rows
    `rows` and the columns grown by L on each side, with the window's
    classes from the uint8 plane `solid`: forcing at fluid sources of
    global column 0 whose guard holds at the level being read, then the
    collision and each level site's class."""
    _, _, _, _, _, _, _, a14, a58 = kernel_constants(cfg)
    delta = torch.zeros(NSPEEDS, dtype=torch.float32)
    delta[[1, 5, 8]] = torch.tensor([a14, a58, a58])
    delta[[3, 6, 7]] = torch.tensor([-a14, -a58, -a58])
    delta = delta.to(src.device)[:, None, None]
    cols = torch.arange(c0 - L, c0 + ce + L, device=src.device) % cfg.ny
    cur = src[:, rows][:, :, cols].float()
    cls = solid[rows][:, cols]
    for _ in range(L):
        h, w = cur.shape[1], cur.shape[2]
        ok = ((cur[6] - a58 > 0) & (cur[3] - a14 > 0) & (cur[7] - a58 > 0)
              & (cols == 0)[None, :] & (cls == 0))
        forced = torch.where(ok[None], cur + delta, cur)
        pulled = torch.stack([
            forced[s, 1 - int(E[s, 0]):h - 1 - int(E[s, 0]), 1 - int(E[s, 1]):w - 1 - int(E[s, 1])]
            for s in range(NSPEEDS)])
        cls = cls[1:-1, 1:-1]
        cur = _collide_classes(pulled, cls, cfg).to(src.dtype).float()
        cols = cols[1:-1]
    return cur.to(src.dtype)


def _check_flat(f2: torch.Tensor, cfg: LatticeConfig, n_steps: int) -> None:
    st = _storage(cfg)
    check_device(f2)
    shape = (2, NSPEEDS, cfg.nx, cfg.ny)
    if f2.dtype != st:
        raise TypeError(f"f2 must be {st} (the config's storage), got {f2.dtype}")
    if tuple(f2.shape) != shape:
        raise ValueError(f"f2 must be the stacked ping-pong pair {shape}, got {tuple(f2.shape)}")
    if not f2.is_contiguous():
        raise ValueError("f2 must be contiguous")
    _check_flat_count(n_steps)


def _check_flat_count(n_steps: int) -> None:
    if not isinstance(n_steps, int) or n_steps < 2 or n_steps % 2:
        raise ValueError(f"the flat kernel's step count must be even and at least 2 (the "
                         f"result returns to parity 0), got {n_steps!r}")


def _check_temporal(temporal: int) -> None:
    """Raise unless `temporal`, the steps of a pass, is an integer in [1,
    FLAT_MAX_TEMPORAL]."""
    if (not isinstance(temporal, int) or isinstance(temporal, bool)
            or not 1 <= temporal <= FLAT_MAX_TEMPORAL):
        raise ValueError(f"temporal must be an integer in [1, {FLAT_MAX_TEMPORAL}], "
                         f"got {temporal!r}")


def flat_step(f2: torch.Tensor, cfg: LatticeConfig, n_steps: int, *, temporal: int | None = None,
              fast_math: bool = False, blocks: int | None = None) -> torch.Tensor:
    """n_steps wall-free steps in one launch, in place; returns f2.

    f2: the stacked (2, 9, NX, NY) ping-pong pair of the config's storage
    dtype (float32 or bfloat16) with the live state at parity 0; the
    result is back at parity 0 and parity 1 holds the state one step
    earlier, so n_steps must be even. temporal: the most steps a pass
    keeps in shared memory (default FLAT_TEMPORAL by storage; the pass
    plan is flat_schedule's); it does not change the result, bit for
    bit. On a CUDA tensor it makes one cooperative launch on the current
    stream (a grid sized to what the card holds at once, or `blocks`
    CTAs; a refused launch raises RuntimeError) and counts it in
    FLAT_LAUNCHES; a temporal whose pass leaves no output tile in the
    card's tile (flat_tile) raises ValueError there. On a CPU tensor it
    writes flat_reference's result."""
    global FLAT_LAUNCHES
    _check_flat(f2, cfg, n_steps)
    temporal = FLAT_TEMPORAL[f2.dtype] if temporal is None else temporal
    plan = _flat_runs(flat_schedule(n_steps, temporal))
    if blocks is not None and (not isinstance(blocks, int) or blocks < 1):
        raise ValueError(f"blocks must be a positive integer or None, got {blocks!r}")
    if f2.device.type == "cpu":
        f2.copy_(flat_reference(f2, cfg, n_steps))
        return f2
    tile = flat_tile(f2.dtype, f2.device)
    if min(flat_output(tile, f2.dtype, temporal)) < 1:
        raise ValueError(f"the flat kernel's tile {tile} leaves no output at "
                         f"temporal={temporal} ({f2.dtype})")
    vec = cfg.ny % WIDE_COLUMNS[f2.dtype] == 0 and f2.data_ptr() % WIDE_ALIGN == 0
    params = (ctypes.c_float * 9)(*kernel_constants(cfg))
    runs = (ctypes.c_int64 * len(plan))(*plan)
    rc = cuda_build.load_library().lbm_flat_steps_launch(
        f2.data_ptr(), cfg.nx, cfg.ny, _STORAGE[f2.dtype], int(fast_math), ctypes.addressof(runs),
        int(vec), blocks or 0, ctypes.addressof(params),
        torch.cuda.current_stream(f2.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"lbm_flat_steps cooperative launch failed: cudaError {rc}")
    FLAT_LAUNCHES += 1
    return f2


def make_flat_step(
    cfg: LatticeConfig,
    n_steps: int,
    *,
    temporal: int | None = None,
    walls=None,
    wall_spec=None,
    slip_x=None,
    slip_y=None,
    fast_math: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The flat step of n_steps steps as a call f2 -> f2 (in place), the
    twin of the JAX package's make_flat_step (ops/fused_kernel.py:1799
    there), whose passes x steps per pass are one count here; temporal,
    the JAX make_flat_step's own parameter, is the most steps a pass runs
    (default FLAT_TEMPORAL by storage). The flat kernel is wall-free: a
    mask with a solid site, a non-empty wall spec, slip masks or an odd
    count raise ValueError, as the JAX guards do (:387-404 there)."""
    if walls is not None and np.asarray(_host_mask(walls), dtype=bool).any():
        raise ValueError("the flat kernel is wall-free only: the mask has solid sites "
                         "(walls keep one launch per step)")
    if wall_spec:
        raise ValueError(f"the flat kernel is wall-free only: got the wall spec {wall_spec!r}")
    if slip_x is not None or slip_y is not None:
        raise ValueError("the flat kernel is wall-free only: it takes no slip masks")
    st = _storage(cfg)
    _check_flat_count(n_steps)
    temporal = FLAT_TEMPORAL[st] if temporal is None else temporal
    _check_temporal(temporal)

    def step(f2: torch.Tensor) -> torch.Tensor:
        return flat_step(f2, cfg, n_steps, temporal=temporal, fast_math=fast_math)

    return step


def temporal_reference(src: torch.Tensor, geom, cfg: LatticeConfig, steps: int, *,
                       fast_math: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the temporal form: `steps` chained
    step_reference calls from src, which bfloat16 rounds to storage after
    every one. geom: None, a uint8 (NX, NY) class plane or a wall spec, as
    step's. Returns a new tensor. It computes IEEE 1/rho: the kernel's
    fast-math variant is held to it within FAST_MATH_RTOL."""
    _check_temporal(steps)
    plane, spec = (None, geom) if isinstance(geom, tuple) else (geom, None)
    out = src
    for _ in range(steps):
        out = step_reference(out, plane, cfg, wall_spec=spec, fast_math=fast_math)
    return out


def temporal_reference_blocked(src: torch.Tensor, geom, cfg: LatticeConfig, steps: int,
                               tile: FlatTile) -> torch.Tensor:
    """Plain PyTorch version of the temporal form's tiling:
    temporal_reference's result, computed the way
    csrc/lbm_temporal_step.cu computes it, one pass of `steps` steps tile
    by tile: output tiles of flat_output(tile, dtype, steps) sites (ragged
    at the last row and column), each from its source and its classes
    grown by `steps` on each side with periodic wrap by modulo indices (a
    site may appear more than once), levels each one site smaller on each
    side, the forcing at fluid sources of GLOBAL column 0 with the guard
    read at the level being read, each level site's class after the
    collision, and bfloat16 rounded to storage after every level. tile: any
    rows and width that leave an output tile (temporal_info gives the
    kernel's on a card). Returns a new tensor."""
    _check_temporal(steps)
    tile = FlatTile(*tile)
    if min(flat_output(tile, src.dtype, steps)) < 1:
        raise ValueError(f"tile {tile} leaves no output tile at {steps} steps")
    out = torch.empty_like(src)
    _blocked_pass(src, out, _solid_plane(geom, cfg, src.device), cfg, steps, tile)
    return out


def tile_max_steps(tile: FlatTile, dtype: torch.dtype) -> int:
    """The deepest pass, at most FLAT_MAX_TEMPORAL steps, whose output
    tiles (flat_output) in `tile` hold a site; 0 if none does."""
    steps = [n for n in range(1, FLAT_MAX_TEMPORAL + 1) if min(flat_output(tile, dtype, n)) >= 1]
    return max(steps, default=0)


def temporal_info(dtype: torch.dtype, geometry_kind: str = "spec", device=None,
                  ext: bool = False, rdma: bool = False, launch=None) -> dict:
    """What a card gives the temporal form (ext: its ext-halo form; rdma:
    its rdma form) for storage `dtype` and a geometry kind ("none",
    "plane", "spec"), as csrc/lbm_temporal_step.cu and
    csrc/lbm_temporal_rdma_step.cu decide it from the card's shared
    memory: the card's largest tile, `rows` and `width` (one tile per
    storage type, the same in every form), `max_steps` (the deepest pass
    the tile takes, tile_max_steps), `registers` and `local_bytes` (stack
    and spills) per thread, `ctas_per_sm`, `shared_bytes_per_cta`, the
    CTA's `threads` and its tile `buffers`. With ext or rdma, `launch` =
    (rows, ny, steps) of one launch (rdma: (rows, ny, steps,
    card_shards)) adds its `plan` (ext_temporal_plan, rdma_temporal_grid).
    Needs a CUDA card (default: the current one); read once per card."""
    name = ("lbm_temporal_steps_rdma_info" if rdma else
            "lbm_temporal_steps_ext_info" if ext else "lbm_temporal_steps_info")
    index = None if device is None else torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    info = dict(_temporal_info(dtype, _GEOMETRY[geometry_kind], index, name))
    if launch is not None:
        if rdma:
            info["plan"] = rdma_temporal_grid(dtype, geometry_kind, *launch, device=index)
        elif ext:
            info["plan"] = ext_temporal_plan(dtype, geometry_kind, *launch, device=index)
        else:
            raise ValueError("a launch's plan is the shard forms' (ext or rdma)")
    return info


@functools.cache
def _temporal_info(dtype: torch.dtype, geometry: int, index: int,
                   name: str = "lbm_temporal_steps_info") -> dict:
    out = (ctypes.c_int64 * 8)()
    with torch.cuda.device(index):
        rc = getattr(cuda_build.load_library(), name)(_STORAGE[dtype], geometry, out)
    if rc != 0:
        raise RuntimeError(f"{name} failed: cudaError {rc}")
    tile = FlatTile(out[4], out[5])
    return {"registers": out[0], "ctas_per_sm": out[1], "shared_bytes_per_cta": out[2],
            "local_bytes": out[3], "rows": tile.rows, "width": tile.width,
            "max_steps": tile_max_steps(tile, dtype), "threads": out[6], "buffers": out[7]}


def temporal_form_takes(dtype: torch.dtype, ny: int) -> bool:
    """Whether the temporal form takes rows of ny columns of storage
    `dtype`: whole 16-byte vectors (WIDE_COLUMNS)."""
    return ny % WIDE_COLUMNS[dtype] == 0


def default_temporal(dtype: torch.dtype, ny: int, device_type: str, max_steps: int) -> int:
    """The depth Session(temporal=None) runs: on a CUDA card where the
    temporal form takes rows of ny columns of storage `dtype`
    (temporal_form_takes), DEFAULT_TEMPORAL[dtype], at most `max_steps`
    (the deepest pass the card's tile takes: temporal_info); else 1, one
    step a launch. On the CPU a pass is temporal_reference, a plain
    emulation with nothing to gain."""
    if device_type != "cuda" or not temporal_form_takes(dtype, ny):
        return 1
    return max(1, min(DEFAULT_TEMPORAL[dtype], max_steps))


def _check_tile_depth(steps: int, dtype: torch.dtype, device: torch.device) -> None:
    """On a card, raise ValueError when a pass of `steps` steps is deeper
    than the temporal form's tile takes there (temporal_info)."""
    if device.type == "cuda":
        info = temporal_info(dtype, device=device)
        if steps > info["max_steps"]:
            raise ValueError(f"a pass of {steps} steps leaves no output tile in the temporal "
                             f"form's {info['rows']}x{info['width']} tile on {device} ({dtype}): "
                             f"it takes at most {info['max_steps']}")


def _check_temporal_pass(steps: int, dtype: torch.dtype, ny: int, device: torch.device) -> None:
    """Raise ValueError unless the temporal form takes a pass of `steps`
    steps on rows of ny columns of storage `dtype` on `device`: whole
    16-byte vectors a row and, on a card, no deeper than its tile takes
    (temporal_info)."""
    _check_temporal(steps)
    if not temporal_form_takes(dtype, ny):
        v = WIDE_COLUMNS[dtype]
        raise ValueError(f"temporal blocking needs NY a multiple of {v} columns ({dtype}: one "
                         f"16-byte vector), got NY {ny}; Session(temporal=T) runs one step per "
                         "launch at such an NY")
    _check_tile_depth(steps, dtype, device)


def temporal_step(
    src: torch.Tensor,
    dst: torch.Tensor,
    geom,
    cfg: LatticeConfig,
    steps: int,
    *,
    fast_math: bool = False,
) -> torch.Tensor:
    """One pass of `steps` steps src -> dst; returns dst. geom, src, dst
    and fast_math as step's; NY a multiple of a 16-byte vector's columns
    (4 in float32, 8 in bf16), else ValueError. On a CUDA tensor it
    launches the temporal kernel on the current stream and counts it in
    TEMPORAL_LAUNCHES, TEMPORAL_VARIANT_LAUNCHES and TEMPORAL_STEPS; a
    buffer or class plane not aligned to WIDE_ALIGN bytes, or more steps
    than the card's tile takes (temporal_info), raise ValueError, and
    nothing runs in their place. On a CPU tensor it writes
    temporal_reference's result. Raises on anything the kernel does not
    take, and on any other device."""
    global TEMPORAL_LAUNCHES, TEMPORAL_STEPS
    kind, info = _check(src, dst, geom, cfg)
    _check_temporal_pass(steps, src.dtype, cfg.ny, src.device)
    if src.device.type == "cpu":
        dst.copy_(temporal_reference(src, geom, cfg, steps, fast_math=fast_math))
        return dst
    pointers = [src.data_ptr(), dst.data_ptr()] + ([geom.data_ptr()] if kind == "plane" else [])
    if any(ptr % WIDE_ALIGN for ptr in pointers):
        raise ValueError(f"the temporal form needs buffers aligned to {WIDE_ALIGN} bytes; "
                         f"pointers mod {WIDE_ALIGN}: {[ptr % WIDE_ALIGN for ptr in pointers]}")
    params = (ctypes.c_float * 9)(*kernel_constants(cfg))
    spec = (ctypes.c_int64 * SPEC_FIELDS)(*info) if kind == "spec" else None
    rc = cuda_build.load_library().lbm_temporal_steps_launch(
        src.data_ptr(), dst.data_ptr(), geom.data_ptr() if kind == "plane" else None,
        ctypes.addressof(spec) if spec is not None else None,
        cfg.nx, cfg.ny, _STORAGE[src.dtype], _GEOMETRY[kind], int(fast_math), steps,
        ctypes.addressof(params), torch.cuda.current_stream(src.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"lbm_temporal_steps launch failed: cudaError {rc}")
    TEMPORAL_LAUNCHES += 1
    TEMPORAL_STEPS += steps
    TEMPORAL_VARIANT_LAUNCHES[variant_name(src.dtype, kind, kind == "plane" and info > 1,
                                           fast_math)] += 1
    return dst


# --- a shard's passes: the ext-halo and rdma temporal forms -----------------


def _ext_temporal_block(src, halo, geom, cfg: LatticeConfig, row_offset: int):
    """(block, solid, Td): the halo-extended (9, Td + Ls + Td, NY) block
    (top, src, bot) of a shard and its uint8 class rows (None for the
    wall-free variant; a ShardPlane's plane with its (Td, NY) halo class
    rows; a wall spec taken at the global rows row_offset - Td ..
    row_offset + Ls + Td - 1, periodic in cfg.nx)."""
    top, bot = halo
    depth = top.shape[1]
    if bot.shape[1] != depth:
        raise ValueError(f"halo blocks of {depth} and {bot.shape[1]} rows")
    block = torch.cat([top, src, bot], dim=1)
    if geom is None:
        solid = None
    elif isinstance(geom, ShardPlane):
        solid = torch.cat([geom.top, geom.plane, geom.bot])
    else:
        solid = _spec_rows(geom, cfg, row_offset - depth, block.shape[1], src.device)
    return block, solid, depth


def temporal_reference_ext(src: torch.Tensor, halo, geom, cfg: LatticeConfig, steps: int, *,
                           row_offset: int = 0, fast_math: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the ext-halo temporal form on a whole
    shard: `steps` chained step_reference calls on the halo-extended block
    (the top halo's Td rows, the shard's Ls rows, the bottom halo's Td
    rows) with its class rows, then the shard's rows; after steps <= Td
    steps the extended block's own x wrap has not reached them. bf16
    rounds to storage after every step.

    src: the shard's (9, Ls, NY) block, local row 0 at global row
    row_offset of the cfg.nx-row lattice; halo: (top, bot), (9, Td, NY)
    blocks, the Td rows above and below it, all 9 planes. geom: None; a
    ShardPlane whose top and bot are the halo rows' (Td, NY) class rows
    (codes 0-3); or a wall spec, evaluated at the global rows row_offset -
    Td .. row_offset + Ls + Td - 1, periodic in cfg.nx. It computes IEEE
    1/rho: the kernel's fast-math variant is held to it within
    FAST_MATH_RTOL. Returns a new (9, Ls, NY) tensor."""
    block, solid, depth = _ext_temporal_block(src, halo, geom, cfg, row_offset)
    if steps > depth:
        raise ValueError(f"a pass of {steps} steps reads {steps} halo rows a side; the halos "
                         f"hold {depth}")
    out = temporal_reference(block, solid, cfg, steps, fast_math=fast_math)
    return out[:, depth:depth + src.shape[1]]


def temporal_reference_ext_blocked(src: torch.Tensor, halo, geom, cfg: LatticeConfig,
                                   steps: int, tile: FlatTile, *, row_offset: int = 0,
                                   row0: int = 0, rows: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the ext-halo temporal form's tiling: the
    rows [row0, row0 + rows) (default: to the shard's end) of
    temporal_reference_ext's result, computed the way
    csrc/lbm_temporal_step.cu's ext-halo form computes them: output tiles
    of flat_output(tile, dtype, steps) sites laid from row0, each from its
    source rows grown by `steps` a side, where local row q < 0 reads top
    halo row Td + q and q >= Ls reads bottom halo row q - Ls, columns by
    modulo, then the levels of temporal_reference_blocked. The arguments of
    temporal_reference_ext, and tile (any rows and width that leave an
    output tile; temporal_info gives the kernel's on a card). Raises where
    a tile would read past a halo. Returns a (9, rows, NY) tensor."""
    _check_temporal(steps)
    tile = FlatTile(*tile)
    if min(flat_output(tile, src.dtype, steps)) < 1:
        raise ValueError(f"tile {tile} leaves no output tile at {steps} steps")
    n = src.shape[1]
    rows = n - row0 if rows is None else rows
    if not (0 <= row0 and rows >= 1 and row0 + rows <= n):
        raise ValueError(f"rows [{row0}, {row0 + rows}) outside the shard's {n} rows")
    block, solid, depth = _ext_temporal_block(src, halo, geom, cfg, row_offset)
    if solid is None:
        solid = torch.zeros(block.shape[1:], dtype=torch.uint8, device=src.device)

    def source_rows(r0, re):
        q0, q1 = row0 + r0 - steps, row0 + r0 + re + steps
        if q0 < -depth or q1 > n + depth:
            raise ValueError(f"a tile at rows [{row0 + r0}, {row0 + r0 + re}) reads rows "
                             f"[{q0}, {q1}) past the {depth}-row halos of a {n}-row shard")
        return torch.arange(q0, q1) + depth

    out = src.new_empty((NSPEEDS, rows, cfg.ny))
    _blocked_pass(block, out, solid, cfg, steps, tile, rows, source_rows)
    return out


def tile_cost(dtype: torch.dtype, out_rows: int, steps: int, width: int = TILE_WIDTH) -> float:
    """The estimated time (ns on one SM) of one output tile of out_rows
    rows of the shard forms in a pass of `steps` steps: the larger of its
    bytes (its source sites, 9 values and a class byte each, read; its
    output sites written) at TILE_NS_PER_BYTE and its levels' site
    updates at TILE_NS_PER_SITE[dtype] (a CTA's next tile loads under its
    current tile's levels). The twin of csrc/lbm_temporal.cuh's
    tile_cost."""
    v = WIDE_COLUMNS[dtype]
    pad = -(-steps // v) * v
    c = width - 2 * pad
    cols = (-(-(pad + c + steps) // v) - (pad - steps) // v) * v
    site = 9 * torch.empty((), dtype=dtype).element_size()
    n_bytes = float(out_rows + 2 * steps) * cols * (site + 1) + float(out_rows) * c * site
    updates = 0.0
    for g in range(steps):
        updates += float(out_rows + 2 * g) * (c + 2 * g)
    return max(TILE_NS_PER_BYTE * n_bytes, TILE_NS_PER_SITE[dtype] * updates)


def rdma_tile_grid(dtype: torch.dtype, out_rows: int, rows: int, ny: int, steps: int, slots: int,
                   card_shards: int, width: int = TILE_WIDTH) -> dict | None:
    """The rdma temporal form's grid for a shard of `rows` rows at output
    tiles of out_rows rows on a card of `slots` co-resident CTAs that
    card_shards launches share: `interior_tiles` and `edge_tiles` (the
    row blocks whose source rows reach a halo) and `ctas`, the CTAs it
    launches: every one of them may wait for the neighbours' rows, so at
    most (slots - 1) // card_shards, and no more than its RDMA_SENDERS
    senders and its tiles; None where the launch would be refused. The
    twin of csrc/lbm_temporal_rdma_step.cu's rdma_grid_at."""
    c = width - 2 * (-(-steps // WIDE_COLUMNS[dtype]) * WIDE_COLUMNS[dtype])
    if out_rows < 1 or c < 1:
        return None
    tiles_y = -(-ny // c)
    nb = -(-rows // out_rows)
    i0 = min(-(-steps // out_rows), nb)
    last = (rows - steps) // out_rows if rows >= steps else 0
    i1 = max(min(last, nb - 1), i0)
    most = (slots - 1) // card_shards
    if nb * tiles_y >= 1 << 30 or most < RDMA_SENDERS:
        return None
    interior, edge = (i1 - i0) * tiles_y, (nb - (i1 - i0)) * tiles_y
    return {"ctas": min(most, RDMA_SENDERS + interior + edge), "interior_tiles": interior,
            "edge_tiles": edge}


def shard_tile_plan(dtype: torch.dtype, rows: int, ny: int, steps: int, max_rows: int,
                    slots: int, *, rdma: bool = False, card_shards: int = 1,
                    width: int = TILE_WIDTH) -> dict | None:
    """The tile plan of one launch of a shard form, the twin of
    csrc/lbm_temporal.cuh's plan_tiles: over every output tile height R in
    [1, max_rows - 2 steps] (max_rows: the card's largest tile,
    temporal_info), the launch's output tiles over its `rows` rows
    (ext-halo form: one CTA a tile up to `slots`, the card's co-resident
    CTAs; rdma form: rdma_tile_grid, the whole shard) and the tiles its
    busiest CTA walks ("waves"; the rdma form's CTAs take tiles from a
    counter, so about tiles / ctas); the R of the least waves x tile_cost wins,
    the larger R on a tie. Returns {"rows": the tile's rows, halos
    included, "output_rows": R, "tiles", "ctas", "waves", "cost" (ns),
    and rdma_tile_grid's keys with rdma}, or None where no R gives a
    launch."""
    best = None
    c = width - 2 * (-(-steps // WIDE_COLUMNS[dtype]) * WIDE_COLUMNS[dtype])
    for r in range(max_rows - 2 * steps, 0, -1) if c >= 1 else ():
        if rdma:
            grid = rdma_tile_grid(dtype, r, rows, ny, steps, slots, card_shards, width)
            if grid is None:
                continue
            tiles = grid["interior_tiles"] + grid["edge_tiles"]
            p = {**grid, "tiles": tiles, "waves": -(-tiles // grid["ctas"])}
        else:
            tiles = -(-rows // r) * -(-ny // c)
            if tiles >= 1 << 30:
                continue
            ctas = min(tiles, slots)
            p = {"tiles": tiles, "ctas": ctas, "waves": -(-tiles // ctas)}
        p.update(rows=r + 2 * steps, output_rows=r,
                 cost=float(p["waves"]) * tile_cost(dtype, r, steps, width))
        if best is None or p["cost"] < best["cost"]:
            best = p
    return best


def ext_temporal_plan(dtype: torch.dtype, geometry_kind: str, rows: int, ny: int, steps: int,
                      device=None, tile_rows: int | None = None) -> dict:
    """The plan of one launch of the ext-halo temporal form over `rows`
    output rows as the card's launcher makes it
    (csrc/lbm_temporal_step.cu's lbm_temporal_steps_ext_plan; tile_rows:
    a tile of that many rows instead of the planned one): the tile's
    `rows`, halos included, the launch's `tiles`, the `ctas` it launches
    and the `waves`, the tiles its busiest CTA walks; shard_tile_plan
    computes the same from the card's tile and slots. Needs a CUDA card."""
    out = (ctypes.c_int64 * 4)()
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    with torch.cuda.device(index):
        rc = cuda_build.load_library().lbm_temporal_steps_ext_plan(
            _STORAGE[dtype], _GEOMETRY[geometry_kind], rows, ny, steps, tile_rows or 0, out)
    if rc != 0:
        raise RuntimeError(f"lbm_temporal_steps_ext_plan failed: cudaError {rc}")
    return {"rows": out[0], "tiles": out[1], "ctas": out[2], "waves": out[3]}


def check_ext_temporal_depth(steps: int, dtype: torch.dtype, device) -> None:
    """Raise ValueError unless the shard forms' tile on `device` (the
    ext-halo and rdma forms share it) takes a pass of `steps` steps of
    storage `dtype` (nothing to check on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    info = temporal_info(dtype, device=device, ext=True)
    if steps > info["max_steps"]:
        raise ValueError(f"a pass of {steps} steps leaves no output tile in the temporal form's "
                         f"{info['rows']}x{info['width']} tile on {device} ({dtype}): it takes "
                         f"at most {info['max_steps']}")


def _check_ext_temporal(src, dst, halo, geom, cfg: LatticeConfig, steps: int, row0: int,
                        rows: int, row_offset: int) -> tuple[str, object, int]:
    """Validate a launch of a shard's temporal forms; return the geometry
    kind, what the launch needs of it (the largest class code, or the spec
    fields) and Td (0 without halo)."""
    _check_temporal(steps)
    dtype = _storage(cfg)
    n_rows = check_ext_launch((("src", src), ("dst", dst)), None, dtype, cfg, row0, rows,
                              halo_rows=False)
    if src.data_ptr() == dst.data_ptr():
        raise ValueError("a pass is out of place: src and dst must be distinct buffers")
    if not 0 <= row_offset <= cfg.nx - n_rows:
        raise ValueError(f"a {n_rows}-row shard at global row {row_offset} lies outside "
                         f"the {cfg.nx}-row lattice")
    v = WIDE_COLUMNS[dtype]
    if cfg.ny % v:
        raise ValueError(f"temporal blocking needs NY a multiple of {v} columns ({dtype}: one "
                         f"16-byte vector), got NY {cfg.ny}")
    dev = src.device
    depth = 0
    if halo is not None:
        if len(halo) != 2:
            raise ValueError("halo must be (top, bot), (9, Td, NY) blocks")
        depth = halo[0].shape[1] if halo[0].dim() == 3 else 0
        for t in halo:
            if (t.dtype != dtype or tuple(t.shape) != (NSPEEDS, depth, cfg.ny) or depth < 1
                    or not t.is_contiguous() or t.device != dev):
                raise ValueError(f"halo blocks must be contiguous {dtype} (9, Td, {cfg.ny}) on "
                                 f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if steps > depth:
            raise ValueError(f"a pass of {steps} steps reads {steps} halo rows a side; the "
                             f"halos hold {depth}")
    if row0 - steps < -depth or row0 + rows + steps > n_rows + depth:
        raise ValueError(f"rows [{row0}, {row0 + rows}) of a {n_rows}-row shard read "
                         f"{steps} rows a side, past {depth} halo rows: give the halos")
    if geom is None:
        kind, info = "none", None
    elif isinstance(geom, ShardPlane):
        kind = "plane"
        info = check_solid_plane(geom.plane, (n_rows, cfg.ny), dev)
        if halo is not None:
            for t in (geom.top, geom.bot):
                info = max(info, check_solid_plane(t, (depth, cfg.ny), dev))
    elif isinstance(geom, tuple):
        kind, info = "spec", kernel_spec(geom, cfg.nx, cfg.ny)
    else:
        raise ValueError(f"a shard's temporal forms take None, a ShardPlane or a wall spec, "
                         f"got {type(geom)}")
    if dev.type == "cuda":
        check_ext_temporal_depth(steps, dtype, dev)
        tensors = [src, dst] + (list(halo) if halo is not None else [])
        if kind == "plane":
            tensors += [geom.plane] + ([geom.top, geom.bot] if halo is not None else [])
        if any(t.data_ptr() % WIDE_ALIGN for t in tensors):
            raise ValueError(f"the temporal forms need buffers aligned to {WIDE_ALIGN} bytes; "
                             f"pointers mod {WIDE_ALIGN}: "
                             f"{[t.data_ptr() % WIDE_ALIGN for t in tensors]}")
    return kind, info, depth


def _check_tile_rows(tile_rows, steps: int, dtype: torch.dtype, device: torch.device) -> None:
    """Raise ValueError unless tile_rows is None (the plan's tile) or the
    rows of a tile that leaves output rows in a pass of `steps` steps and,
    on a card, fits the shard forms' largest tile there."""
    if tile_rows is None:
        return
    if (not isinstance(tile_rows, int) or isinstance(tile_rows, bool)
            or tile_rows < 2 * steps + 1):
        raise ValueError(f"tile_rows must be an integer of at least 2 steps + 1 = {2 * steps + 1}"
                         f", got {tile_rows!r}")
    if device.type == "cuda":
        most = temporal_info(dtype, device=device, ext=True)["rows"]
        if tile_rows > most:
            raise ValueError(f"tile_rows {tile_rows} exceeds the card's tile of {most} rows")


def ext_temporal_launcher(
    src: torch.Tensor,
    dst: torch.Tensor,
    halo,
    geom,
    cfg: LatticeConfig,
    steps: int,
    *,
    row0: int = 0,
    rows: int | None = None,
    row_offset: int = 0,
    fast_math: bool = False,
    tile_rows: int | None = None,
) -> Callable[[], None]:
    """Validate one launch of the ext-halo temporal form and return it as a
    call with no arguments, to be made any number of times: a pass of
    `steps` steps that writes the local rows [row0, row0 + rows) (default:
    all) of the shard src -> dst from the buffers' contents at that time,
    at the tile of the launch's plan (ext_temporal_plan; `launch.plan` on
    a card) or, with tile_rows, at a tile of that many rows (halos
    included, at most the card's: temporal_info).

    src, dst: the shard's (9, Ls, NY) blocks of the storage dtype, distinct,
    NY a multiple of WIDE_COLUMNS (one 16-byte vector), local row 0 at
    global row row_offset. halo: (top, bot), (9, Td, NY) blocks, the Td >=
    steps rows above and below the shard, all 9 planes; needed unless the
    pass reads only the shard's rows (row0 >= steps and row0 + rows + steps
    <= Ls; else None). geom: None, a ShardPlane whose top and bot are the
    halos' (Td, NY) class rows, or a wall spec (evaluated at global rows).
    On CUDA tensors the call launches the kernel on the current stream and
    counts it in EXT_TEMPORAL_LAUNCHES, EXT_TEMPORAL_VARIANT_LAUNCHES and
    EXT_TEMPORAL_STEPS; a buffer not aligned to WIDE_ALIGN bytes or a pass
    deeper than the card's tile takes raise ValueError here, and nothing
    runs in their place. On CPU tensors the call writes
    temporal_reference_ext's rows. Raises on anything the kernel does not
    take, and on any other device."""
    n_rows = src.shape[1] if src.dim() == 3 else 0
    rows = n_rows - row0 if rows is None else rows
    kind, info, depth = _check_ext_temporal(src, dst, halo, geom, cfg, steps, row0, rows,
                                            row_offset)
    _check_tile_rows(tile_rows, steps, src.dtype, src.device)
    if src.device.type == "cpu":
        def reference():
            if halo is None:
                # the pass reads no halo row: any rows of the right depth
                h = (src.new_zeros((NSPEEDS, steps, cfg.ny)),) * 2
                g = geom
                if kind == "plane":
                    none = geom.plane.new_zeros((steps, cfg.ny))
                    g = ShardPlane(geom.plane, none, none)
            else:
                h, g = halo, geom
            if tile_rows is None:
                out = temporal_reference_ext(src, h, g, cfg, steps, row_offset=row_offset)
                dst[:, row0:row0 + rows].copy_(out[:, row0:row0 + rows])
            else:
                dst[:, row0:row0 + rows].copy_(temporal_reference_ext_blocked(
                    src, h, g, cfg, steps, FlatTile(tile_rows, TILE_WIDTH),
                    row_offset=row_offset, row0=row0, rows=rows))

        return reference

    # host arrays the launch reads: kept alive by the closure
    params = (ctypes.c_float * 9)(*kernel_constants(cfg))
    spec = (ctypes.c_int64 * SPEC_FIELDS)(*info) if kind == "spec" else None
    top, bot = halo if halo is not None else (None, None)
    plane = geom if kind == "plane" else ShardPlane(None, None, None)
    if halo is None:
        plane = ShardPlane(plane.plane, None, None)
    fn = cuda_build.load_library().lbm_temporal_steps_ext_launch
    args = (_ptr(src), _ptr(dst), _ptr(top), _ptr(bot), _ptr(plane.plane), _ptr(plane.top),
            _ptr(plane.bot), ctypes.addressof(spec) if spec is not None else None,
            n_rows, cfg.ny, depth, row0, rows, row_offset, cfg.nx, _STORAGE[src.dtype],
            _GEOMETRY[kind], int(fast_math), steps, ctypes.addressof(params), tile_rows or 0)
    variant = variant_name(src.dtype, kind, kind == "plane" and info > 1, fast_math)
    device = src.device
    plan = ext_temporal_plan(src.dtype, kind, rows, cfg.ny, steps, device, tile_rows)

    def launch():
        global EXT_TEMPORAL_LAUNCHES, EXT_TEMPORAL_STEPS
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"lbm_temporal_steps ext-halo launch failed: cudaError {rc}")
        EXT_TEMPORAL_LAUNCHES += 1
        EXT_TEMPORAL_STEPS += steps
        EXT_TEMPORAL_VARIANT_LAUNCHES[variant] += 1

    launch.host_args = (params, spec)  # alive as long as the call
    launch.plan = plan
    return launch


def rdma_temporal_schedule(rows: int, depth: int, steps: int, pass_: int) -> dict:
    """The schedule of the in-kernel halo exchange of a pass (the rdma
    temporal form) as plain Python constants, the twin of rdma_schedule at
    depth `depth` and of the JAX kernel's rdma_schedule at temporal = T
    (ops/fused_kernel.py:137-179 there; top_halo_rows = (hr - T, hr)): pass
    `pass_` (1, 2, ... since the flags were zeroed) of `steps` <= depth
    steps on a `rows`-row shard sends the shard's first `steps` rows into
    rows [0, steps) of the upper neighbour's bot[parity] and its last
    `steps` rows into rows [depth - steps, depth) of the lower neighbour's
    top[parity], then sets their flags to `flag`; the shard's edge tiles
    read those rows of its own comm blocks once both its flags hold at
    least `flag`. The kernel (csrc/lbm_temporal_rdma_step.cu) restates
    this; its plain versions read it from here. The reuse discipline is
    rdma_schedule's: two parities, monotonic flag values."""
    return dict(
        parity=pass_ % 2,
        flag=pass_,
        up=-1,
        down=+1,
        send_up_rows=(0, steps),                   # -> the upper neighbour's bot[parity]
        up_bot_rows=(0, steps),
        send_down_rows=(rows - steps, rows),       # -> the lower neighbour's top[parity]
        down_top_rows=(depth - steps, depth),
        top_flag=0,
        bot_flag=1,
    )


def rdma_temporal_send_reference(src: torch.Tensor, up: RdmaEnd, down: RdmaEnd, steps: int,
                                 pass_: int) -> None:
    """Plain PyTorch version of a pass's send role: the shard's first and
    last `steps` rows into its neighbours' comm blocks, then their flags,
    by rdma_temporal_schedule."""
    s = rdma_temporal_schedule(src.shape[1], up.bot.shape[2], steps, pass_)
    (a, b), (c, d) = s["send_up_rows"], s["up_bot_rows"]
    up.bot[s["parity"]][:, c:d].copy_(src[:, a:b])
    up.flags[s["bot_flag"]] = s["flag"]
    (a, b), (c, d) = s["send_down_rows"], s["down_top_rows"]
    down.top[s["parity"]][:, c:d].copy_(src[:, a:b])
    down.flags[s["top_flag"]] = s["flag"]


def rdma_temporal_compute_reference(src: torch.Tensor, end: RdmaEnd, geom, cfg: LatticeConfig,
                                    steps: int, pass_: int, *, row_offset: int = 0,
                                    tile: FlatTile | None = None) -> torch.Tensor:
    """Plain PyTorch version of a pass's interior and edge roles:
    temporal_reference_ext from the `steps` rows of this pass's parity of
    the comm blocks that the pass reads (and of a ShardPlane's halo class
    rows); with `tile`, temporal_reference_ext_blocked at that tile over the
    whole shard, as the kernel lays its planned tiles. Raises RuntimeError
    where the kernel's edge tiles would wait in vain: a flag below this
    pass's value."""
    depth = end.top.shape[2]
    s = rdma_temporal_schedule(src.shape[1], depth, steps, pass_)
    if int(end.flags.min()) < s["flag"]:
        raise RuntimeError(f"pass {pass_}: a neighbour's rows have not arrived "
                           f"(flags {end.flags.tolist()})")
    (a, b), (c, d) = s["down_top_rows"], s["up_bot_rows"]
    halo = (end.top[s["parity"]][:, a:b], end.bot[s["parity"]][:, c:d])
    if isinstance(geom, ShardPlane):
        geom = ShardPlane(geom.plane, geom.top[a:b], geom.bot[c:d])
    if tile is not None:
        return temporal_reference_ext_blocked(src, halo, geom, cfg, steps, tile,
                                              row_offset=row_offset)
    return temporal_reference_ext(src, halo, geom, cfg, steps, row_offset=row_offset)


def temporal_reference_rdma(srcs, ends, geoms, cfg: LatticeConfig, steps: int,
                            pass_: int, tile: FlatTile | None = None) -> list[torch.Tensor]:
    """Plain PyTorch version of one pass of the rdma temporal form over a
    whole ring: every shard sends (rdma_temporal_send_reference), then
    every shard runs its pass from what it received
    (rdma_temporal_compute_reference, with `tile` tile by tile). srcs: the
    shards' (9, Ls, NY) blocks in row order; ends: their temporal RdmaEnds
    (rdma_end(..., depth=Td)), which this writes; geoms: each shard's None,
    ShardPlane (with (Td, NY) halo class rows) or wall spec. Returns the
    shards' new blocks."""
    n, L = len(srcs), srcs[0].shape[1]
    s = rdma_temporal_schedule(L, ends[0].top.shape[2], steps, pass_)
    for k, src in enumerate(srcs):
        rdma_temporal_send_reference(src, ends[(k + s["up"]) % n], ends[(k + s["down"]) % n],
                                     steps, pass_)
    return [rdma_temporal_compute_reference(src, ends[k], geoms[k], cfg, steps, pass_,
                                            row_offset=k * L, tile=tile)
            for k, src in enumerate(srcs)]


def rdma_temporal_launcher(
    src: torch.Tensor,
    dst: torch.Tensor,
    end: RdmaEnd,
    up: RdmaEnd,
    down: RdmaEnd,
    geom,
    cfg: LatticeConfig,
    steps: int,
    *,
    card_shards: int,
    row_offset: int = 0,
    fast_math: bool = False,
    timeout_s: float = RDMA_TIMEOUT_S,
    stream=None,
    tile_rows: int | None = None,
) -> Callable[[int], None]:
    """Validate one shard's launch of the rdma temporal form and return it
    as a call launch(pass_), to be made once per pass with pass_ = 1, 2, ...
    since rdma_reset: a pass of `steps` steps of the whole shard src -> dst
    from the buffers' contents at that time, after sending its first and
    last `steps` rows to its neighbours' ends, its edge tiles after the
    neighbours' rows of the same pass arrived in `end`; at the tile of the
    launch's plan (rdma_temporal_grid; `launch.plan` on a card, None where
    the card refuses the grid) or, with tile_rows, at a tile of that many
    rows (as ext_temporal_launcher's).

    src, dst: the shard's (9, Ls, NY) blocks, Ls >= steps, NY a multiple of
    WIDE_COLUMNS, local row 0 at global row row_offset. end: the shard's
    own temporal RdmaEnd (rdma_end(cfg, device, depth=Td), Td >= steps);
    up, down: its ring neighbours' (the shard itself on a ring of one),
    which may lie on other cards that this card can address. geom: None, a
    ShardPlane with (Td, NY) halo class rows, or a wall spec.
    card_shards: the ring's launches that share this card (its virtual
    shards; 1 on a card of its own), which bounds the CTAs of each launch
    that may spin (csrc/lbm_temporal_rdma_step.cu). Every shard of the
    ring must make the same call, on CUDA each on a stream of its own
    (`stream`, default: the current one at the call), or the edge tiles
    give up after timeout_s and leave the pass in end.work[1]
    (rdma_timed_out).

    On CUDA tensors the call launches the kernel and counts it in
    RDMA_TEMPORAL_LAUNCHES, RDMA_TEMPORAL_VARIANT_LAUNCHES and
    RDMA_TEMPORAL_STEPS. On CPU tensors it is the plain version in two
    halves, launch.send(pass_) and launch.compute(pass_): a ring calls
    every shard's send before any compute (launch(pass_) runs both, which
    suffices on a ring of one). Raises on anything the kernel does not
    take."""
    L = src.shape[1] if src.dim() == 3 else -1
    depth = end.top.shape[2] if end.top.dim() == 4 else 0
    kind, info, _ = _check_ext_temporal(src, dst, (end.top[0], end.bot[0]), geom, cfg, steps, 0,
                                        L, row_offset)
    if L < steps:
        raise ValueError(f"a pass of {steps} steps sends {steps} rows a side; the shard has {L}")
    for name, e in (("end", end), ("up", up), ("down", down)):
        _check_rdma_end(name, e, src.dtype, cfg.ny, src.device.type, depth=depth)
    if end.top.device != src.device:
        raise ValueError(f"end lies on {end.top.device}, the shard on {src.device}")
    if not isinstance(card_shards, int) or isinstance(card_shards, bool) or card_shards < 1:
        raise ValueError(f"card_shards must be a positive integer, got {card_shards!r}")
    _check_tile_rows(tile_rows, steps, src.dtype, src.device)
    if src.device.type == "cpu":
        tile = None if tile_rows is None else FlatTile(tile_rows, TILE_WIDTH)

        def send(pass_: int) -> None:
            rdma_temporal_send_reference(src, up, down, steps, pass_)

        def compute(pass_: int) -> None:
            dst.copy_(rdma_temporal_compute_reference(src, end, geom, cfg, steps, pass_,
                                                      row_offset=row_offset, tile=tile))

        def reference(pass_: int) -> None:
            send(pass_)
            compute(pass_)

        reference.send, reference.compute = send, compute
        return reference

    lib = cuda_build.load_library()
    if lib.lbm_temporal_steps_rdma_words() != RDMA_TEMPORAL_WORDS:
        raise RuntimeError("the built rdma kernel's launch words differ from "
                           f"RDMA_TEMPORAL_WORDS = {RDMA_TEMPORAL_WORDS}")
    for t in (up.bot, down.top):
        if t.data_ptr() % WIDE_ALIGN:
            raise ValueError(f"the neighbours' comm blocks must be aligned to {WIDE_ALIGN} bytes")
    # host arrays the launch reads: kept alive by the closure
    params = (ctypes.c_float * 9)(*kernel_constants(cfg))
    spec = (ctypes.c_int64 * SPEC_FIELDS)(*info) if kind == "spec" else None
    plane = geom if kind == "plane" else ShardPlane(None, None, None)
    flag = rdma_temporal_schedule(L, depth, steps, 1)
    fn = lib.lbm_temporal_steps_rdma_launch
    args = (_ptr(src), _ptr(dst), _ptr(end.top), _ptr(end.bot), _ptr(up.bot), _ptr(down.top),
            _ptr(end.flags), _ptr(up.flags[flag["bot_flag"]:]), _ptr(down.flags[flag["top_flag"]:]),
            _ptr(end.work), _ptr(plane.plane), _ptr(plane.top), _ptr(plane.bot),
            ctypes.addressof(spec) if spec is not None else None,
            L, cfg.ny, depth, row_offset, cfg.nx, _STORAGE[src.dtype], _GEOMETRY[kind],
            int(fast_math), steps, ctypes.addressof(params))
    variant = variant_name(src.dtype, kind, kind == "plane" and info > 1, fast_math)
    device, timeout_ns = src.device, int(timeout_s * 1e9)
    handle = None if stream is None else stream.cuda_stream

    def launch(pass_: int) -> None:
        global RDMA_TEMPORAL_LAUNCHES, RDMA_TEMPORAL_STEPS
        st = torch.cuda.current_stream(device).cuda_stream if handle is None else handle
        rc = fn(*args, pass_, timeout_ns, card_shards, tile_rows or 0, st)
        if rc != 0:
            raise RuntimeError(f"lbm_temporal_steps rdma launch failed: cudaError {rc}")
        RDMA_TEMPORAL_LAUNCHES += 1
        RDMA_TEMPORAL_STEPS += steps
        RDMA_TEMPORAL_VARIANT_LAUNCHES[variant] += 1

    # what the launch addresses, alive as long as the call
    launch.host_args = (params, spec, src, dst, end, up, down, geom)
    try:
        launch.plan = rdma_temporal_grid(src.dtype, kind, L, cfg.ny, steps, card_shards, device,
                                         tile_rows)
    except RuntimeError:
        launch.plan = None  # a grid the card refuses: the launch raises
    return launch


def rdma_temporal_grid(dtype: torch.dtype, geometry_kind: str, rows: int, ny: int, steps: int,
                       card_shards: int, device=None, tile_rows: int | None = None) -> dict:
    """The plan and grid of one launch of the rdma temporal form on a card,
    for a shard of `rows` rows, as csrc/lbm_temporal_rdma_step.cu lays it:
    the tile's `rows`, halos included, the `ctas` launched (every one of
    which may wait for the neighbours' rows), `interior_tiles` and
    `edge_tiles`, and the `waves`, the tiles a CTA walks if they spread
    evenly (shard_tile_plan(rdma=True) computes the same from the card's
    tile and slots); tile_rows: a tile of that many rows instead of the
    planned one. Needs a CUDA card."""
    out = (ctypes.c_int64 * 5)()
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    with torch.cuda.device(index):
        rc = cuda_build.load_library().lbm_temporal_steps_rdma_grid(
            _STORAGE[dtype], _GEOMETRY[geometry_kind], rows, ny, steps, card_shards,
            tile_rows or 0, out)
    if rc != 0:
        raise RuntimeError(f"lbm_temporal_steps_rdma_grid failed: cudaError {rc}")
    return {"ctas": out[0], "interior_tiles": out[1], "edge_tiles": out[2], "rows": out[3],
            "waves": out[4]}


def _host_mask(x):
    return x.cpu().numpy() if torch.is_tensor(x) else x


def host_geometry(cfg: LatticeConfig, walls, wall_spec=None, slip_x=None, slip_y=None):
    """The geometry a session runs, on the host: with slip masks the
    uint8 class plane (slip masks are arbitrary, so they force the plane,
    as the JAX Session does at ops/fused_kernel.py:2778-2780); else None
    when the mask has no solid site; else wall_spec when one is given
    (the caller vouches that it reproduces `walls`; geometry.infer_spec's
    result does); else the walls as a uint8 plane. Raises on a spec the
    kernel does not take."""
    walls_np = np.asarray(_host_mask(walls), dtype=bool)
    if walls_np.shape != (cfg.nx, cfg.ny):
        raise ValueError(f"walls shape {walls_np.shape} != {(cfg.nx, cfg.ny)}")
    if slip_x is not None or slip_y is not None:
        return class_plane(walls_np, _host_mask(slip_x), _host_mask(slip_y))
    if not walls_np.any():
        return None
    if wall_spec is not None:
        spec = tuple(wall_spec)
        kernel_spec(spec, cfg.nx, cfg.ny)  # refuse what the kernel does not take
        return spec
    return walls_np.astype(np.uint8)


class Session:
    """Persistent state for one lattice configuration on one device: the
    geometry and two preallocated (9, NX, NY) buffers of the storage
    dtype that swap roles every step (the analog of the JAX kernel's
    aliased donor buffer).

    The geometry is host_geometry's: the class plane with slip masks,
    else none for a wall-free mask, else the wall spec when one is given,
    else the walls as a uint8 plane.

    temporal: 1 runs one step-kernel launch per step; T >= 2 runs passes
    of T steps through the temporal form (temporal_step), n steps as n //
    T launches of T steps and one of n % T, each a pass between the two
    buffers. None runs default_temporal's depth: DEFAULT_TEMPORAL by
    storage on a card, no deeper than its tile takes, and one step per
    launch on the CPU; a pass of one step at that depth (an advance of 1,
    or a rest of 1) is a launch of the one-step kernel, the faster form
    of a single step, where an asked T runs it as a pass. Where the temporal form does not take the rows (NY
    of no whole 16-byte vectors: temporal_form_takes), None and T >= 2
    run one step per launch, a choice by shape counted by form in
    FORM_LAUNCHES, as the ds and sharded sessions choose; `temporal`
    reads the depth that runs, `requested_temporal` the one asked. A
    depth no form takes (no integer in [1, FLAT_MAX_TEMPORAL], on a card
    a pass deeper than its tile takes) raises ValueError here, at any
    shape. Every result is bitwise the same. float64 storage raises
    NotImplementedError (ROADMAP B15); run_steps takes it to the portable
    engine.

    The session counts what it ran, always: `launches` and `steps`, added
    once an advance from its pass plan (n and n at depth 1; n // T +
    (n % T > 0) and n at T), and `samples`, one a probe_values call.
    advance, probe_values and state are spans of utils/profiler, and
    block's synchronize a `wait` span.

    Usage:
        sess = Session(cfg, walls, device="cuda", wall_spec=spec)
        sess.load(f)       # copy the state in
        sess.advance(n)    # n steps, no host sync
        sess.block()       # completion barrier
        f = sess.state()   # a copy; the session keeps running
    """

    def __init__(
        self,
        cfg: LatticeConfig,
        walls,
        *,
        device: str | torch.device,
        wall_spec=None,
        slip_x=None,
        slip_y=None,
        fast_math: bool = False,
        temporal: int | None = None,
    ):
        self.dtype = _storage(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.fast_math = fast_math
        if temporal is not None:
            _check_temporal(temporal)
            if temporal > 1:
                _check_tile_depth(temporal, self.dtype, self.device)
        self.requested_temporal = temporal
        if temporal is None:
            on_card = self.device.type == "cuda"
            most = temporal_info(self.dtype, device=self.device)["max_steps"] if on_card else 0
            self.temporal = default_temporal(self.dtype, cfg.ny, self.device.type, most)
        else:
            self.temporal = temporal if temporal_form_takes(self.dtype, cfg.ny) else 1
        geom = host_geometry(cfg, walls, wall_spec, slip_x, slip_y)
        if isinstance(geom, np.ndarray):
            geom = torch.as_tensor(geom, device=self.device)
        self.geom = geom
        self.has_walls = self.geom is not None
        self._a = self._b = None
        self.launches = self.steps = self.samples = 0

    def load(self, f: torch.Tensor) -> None:
        """Copy (9, NX, NY) state into the session's buffers (allocated
        at the first load; a float32 f is rounded to bf16 storage)."""
        if self._a is None:
            shape = (NSPEEDS, self.cfg.nx, self.cfg.ny)
            self._a = torch.empty(shape, dtype=self.dtype, device=self.device)
            self._b = torch.empty_like(self._a)
        self._a.copy_(f)

    def advance(self, n_steps: int) -> None:
        """n_steps steps: one launch per step, or at temporal T passes of
        T steps and one of the rest (at the default depth a rest of one
        step a launch of the one-step kernel); the two buffers swap after
        each launch."""
        depth = self.temporal
        full, rest = divmod(n_steps, depth)
        plan = [depth] * full + ([rest] if rest else [])
        # a pass of one step of the session's own depth runs the one-step
        # kernel, faster than the temporal form at L = 1 (PERF.md, row 1-T)
        one_step = depth == 1 or self.requested_temporal is None
        self.launches += len(plan)
        self.steps += n_steps
        with profiler.span("Session.advance", steps=n_steps, launches=len(plan), depth=depth):
            a, b = self._a, self._b
            for steps in plan:
                if steps == 1 and one_step:
                    step(a, b, self.geom, self.cfg, fast_math=self.fast_math)
                else:
                    temporal_step(a, b, self.geom, self.cfg, steps, fast_math=self.fast_math)
                a, b = b, a
            self._a, self._b = a, b

    def block(self) -> None:
        """Completion barrier for the launches so far."""
        if self.device.type == "cuda":
            with profiler.span("wait"):
                torch.cuda.synchronize(self.device)

    def state(self) -> torch.Tensor:
        """The current state, copied (the session keeps its buffers)."""
        with profiler.span("Session.state"):
            return self._a.clone()

    def probe_sites(self, probes) -> torch.Tensor:
        """(P, 2) probe sites (i, j) as int64 on the session's device;
        raises as stream_collide.probe_sites."""
        return stream_collide.probe_sites(probes, self.cfg, self.device)

    def probe_values(self, sites: torch.Tensor) -> torch.Tensor:
        """(rho, u_x, u_y) at (P, 2) sites (probe_sites)
        of the live buffer: (P, 3), moments in at least float32. Copies
        nothing else of the state."""
        self.samples += 1
        with profiler.span("Session.probe_values"):
            return stream_collide.probe_values(self._a, sites)

    def unload(self) -> torch.Tensor:
        """The current state; the session releases its buffers."""
        out, self._a, self._b = self._a, None, None
        return out


def run_form(cfg: LatticeConfig) -> str:
    """The form run_steps takes for this config's storage: F64_FORM (the
    portable engine) for float64, else KERNEL_FORM; raises on a storage
    the port does not take."""
    return F64_FORM if storage_dtype(cfg.dtype) == torch.float64 else KERNEL_FORM


def _engine_masks(f: torch.Tensor, walls, slip_x, slip_y) -> tuple:
    """walls, slip_x, slip_y as bool tensors on f's device (None stays
    None), for the portable engine."""
    return tuple(None if m is None else torch.as_tensor(m, dtype=torch.bool, device=f.device)
                 for m in (walls, slip_x, slip_y))


def _engine_steps(f: torch.Tensor, masks: tuple, cfg: LatticeConfig, n_steps: int):
    """n_steps of the portable engine from a float64 f on its device,
    counted in F64_STEPS; masks as _engine_masks gives them."""
    global F64_STEPS
    if f.dtype != torch.float64:
        raise TypeError(f"f must be torch.float64 (the config's storage), got {f.dtype}")
    walls, slip_x, slip_y = masks
    out = stream_collide.run_steps(f, walls, cfg, n_steps, slip_x, slip_y)
    F64_STEPS += n_steps
    return out


def run_steps(
    f: torch.Tensor,
    walls,
    cfg: LatticeConfig,
    n_steps: int,
    *,
    wall_spec=None,
    slip_x=None,
    slip_y=None,
    fast_math: bool = False,
    temporal: int | None = None,
) -> torch.Tensor:
    """Unpadded in, unpadded out: the one-shot form of Session on f's
    device. `f` is not modified. A float64 config runs the portable
    engine on f's device instead (F64_FORM, counted in F64_STEPS), with
    the slip masks; wall_spec, fast_math and temporal select nothing
    there, as the JAX run_steps ignores them when its planner returns
    None for float64."""
    if run_form(cfg) == F64_FORM:
        return _engine_steps(f, _engine_masks(f, walls, slip_x, slip_y), cfg, n_steps)
    sess = Session(cfg, walls, device=f.device, wall_spec=wall_spec,
                   slip_x=slip_x, slip_y=slip_y, fast_math=fast_math, temporal=temporal)
    sess.load(f)
    sess.advance(n_steps)
    return sess.unload()


def run_steps_probed(
    f: torch.Tensor,
    walls,
    cfg: LatticeConfig,
    n_steps: int,
    probes,
    *,
    every: int = 1,
    wall_spec=None,
    slip_x=None,
    slip_y=None,
    fast_math: bool = False,
    temporal: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(f_final, series): n_steps steps on f's device with the probe
    gather after every `every` of them, into a preallocated (n_steps //
    every, P, 3) device series; one host sync at most, by the caller.
    `f` is not modified. The JAX runner's choice of pass structure by
    every % (2T) is TPU scheduling: here every `every` steps are one
    Session.advance, which plans its own passes (at temporal T, `every`
    // T passes of T steps and one of the rest), so one schedule serves
    every `every`. A float64 config runs the portable engine as run_steps
    does, `every` steps between gathers in the same loop
    (stream_collide.sample_every), the series float64."""
    if run_form(cfg) == F64_FORM:
        masks = _engine_masks(f, walls, slip_x, slip_y)
        sites = stream_collide.probe_sites(probes, cfg, f.device)

        def advance(n):
            nonlocal f
            f = _engine_steps(f, masks, cfg, n)

        series = stream_collide.sample_every(n_steps, every, len(sites), torch.float64,
                                             f.device, advance,
                                             lambda: stream_collide.probe_values(f, sites))
        return f, series
    sess = Session(cfg, walls, device=f.device, wall_spec=wall_spec,
                   slip_x=slip_x, slip_y=slip_y, fast_math=fast_math, temporal=temporal)
    sess.load(f)
    sites = sess.probe_sites(probes)
    series = stream_collide.sample_every(
        n_steps, every, len(sites), stream_collide.moment_dtype(sess.dtype), sess.device,
        sess.advance, lambda: sess.probe_values(sites))
    return sess.unload(), series
