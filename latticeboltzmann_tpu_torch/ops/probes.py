"""The anatomy probes: wrappers of the four kernels of csrc/lbm_probes.cu
and, beside each, its plain PyTorch version. Twins of the four Pallas
probe kernels of the JAX package's scripts/anatomy.py (copy_pipeline
:89, roll_cost :182, align_cost :211, sublane_roll_cost :245).

- `copy_state`: dst = src for a (9, NX, NY) state, float32 or bfloat16,
  by a direct 16-byte grid-stride loop or staged through shared memory
  in `stages` buffers of `rows` lattice rows (cp.async). Its rate is the
  denominator of every "share of the copy rate" the port reports.
- `roll_y`: n_rolls chained periodic shifts along y of a (rows, NY)
  float32 block held on chip, through shared memory or warp shuffles.
  Shared memory has two forms: "wide" splits each row across a cluster
  of ROLL_Y_CLUSTER CTAs and moves 16-byte vectors through distributed
  shared memory, where NY is a multiple of 4 * ROLL_Y_CLUSTER and the
  blocks are 16-byte aligned; "narrow" takes a row per CTA and any shape.
- `align`: v = a, then n_ops times v = v + b on two offset windows of a
  (R, NY) float32 block, along rows (the TPU probe as written) or along
  columns (the misalignment that matters on this card).
- `roll_x`: n_rolls chained periodic shifts along x (rows) of an (R, NY)
  float32 block, the rows held in shared memory or re-read from global
  memory each roll. Shared memory has two forms: "wide" (16-byte
  vectors, narrow column tiles that fill the card) where NY is a
  multiple of 4 and the blocks are 16-byte aligned, "narrow" anywhere.

form=None picks, for each roll, the form measured faster on an H100
(PERF.md §6) where it takes the shape: DEFAULT_FORM.

Each wrapper launches its kernel for a CUDA tensor, counting the launch
in LAUNCHES (and a roll's form in ROLL_FORM_LAUNCHES), and takes its
plain version for a CPU tensor; anything else raises. Every kernel is
bitwise-equal to its plain version: they move float32 values, or add
them in the same order.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..core.spec import NSPEEDS
from . import cuda_build
from .fused_kernel import check_device

# kernel launches by probe and mechanism: "copy-direct", "copy-staged",
# "roll_y-shared", "roll_y-shuffle", "align-axis0", "align-axis1",
# "roll_x-shared", "roll_x-global"
LAUNCHES: collections.Counter = collections.Counter()
# the shared-memory rolls' launches by form: "roll_y-wide", "roll_y-narrow",
# "roll_x-wide", "roll_x-narrow" (each also counts under "<roll>-shared")
ROLL_FORM_LAUNCHES: collections.Counter = collections.Counter()
FORMS = ("wide", "narrow")
# the form form=None picks where it takes the shape: the faster on an H100
# (PERF.md §6). The wide y-roll loses to the narrow one: the handoff
# between a cluster's CTAs costs more a roll than one SM moving its row.
DEFAULT_FORM = {"roll_y": "narrow", "roll_x": "wide"}

# the staged copy's limits (csrc/lbm_probes.cu): 2..8 stages, and
# stages * rows * NY * itemsize bytes of shared memory in one block
MAX_STAGES = 8
MAX_SHARED_BYTES = 232448
# the shuffle mechanism's limits: the shift within 31 columns of 0 either
# way, rows of at most 32 * 16 * 16 columns
SHUFFLE_MAX_SHIFT = 31
SHUFFLE_MAX_NY = 8192
# the wide forms' shapes, fixed in csrc/lbm_probes.cu: CTAs per row of
# the y-roll (kRollYCluster), 16-byte vectors per one-warp CTA of the
# x-roll (kRollXVecs)
ROLL_Y_CLUSTER = 4
ROLL_X_VECTORS = 2

_ROLL_Y = {"shared": 0, "shuffle": 1}
_ROLL_X = {"shared": 0, "global": 1}


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _check_block(x: torch.Tensor) -> None:
    """Raise unless x is a contiguous float32 (rows, NY) block on the CPU
    or the current card."""
    check_device(x)
    if x.dtype != torch.float32 or x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"x must be a float32 (rows, NY) block, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _out_like(x: torch.Tensor, out: torch.Tensor | None, shape: tuple) -> torch.Tensor:
    """The output block: a new one, or `out` if it fits and is not x."""
    if out is None:
        return torch.empty(shape, dtype=x.dtype, device=x.device)
    if (out.dtype != x.dtype or tuple(out.shape) != tuple(shape) or not out.is_contiguous()
            or out.device != x.device):
        raise ValueError(f"out must be a contiguous {x.dtype} {tuple(shape)} on x's device, "
                         f"got {out.dtype} {tuple(out.shape)} on {out.device}")
    if out.data_ptr() == x.data_ptr():
        raise ValueError("the probe is out of place: out must not be x")
    return out


def _count(n: int, name: str) -> int:
    if not isinstance(n, int) or n < 0:
        raise ValueError(f"{name} must be a non-negative integer, got {n!r}")
    return n


# ------------------------------------------------------------------ copy


def copy_reference(src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the copy kernel: a copy of src."""
    return src.clone()


def copy_state(src: torch.Tensor, dst: torch.Tensor, *, rows: int | None = None,
               stages: int = 4, ctas_per_sm: int | None = None) -> torch.Tensor:
    """dst = src; returns dst. src, dst: distinct contiguous (9, NX, NY)
    states of one dtype, float32 or bfloat16, on one device.

    rows=None is the direct form (16-byte loads and stores, any NY), on a
    grid that covers the buffer; ctas_per_sm=n (1..64) runs it on a
    persistent grid of n CTAs per SM instead, the design the anatomy
    script measures it against.
    rows=r is the staged form: tiles of r lattice rows through `stages`
    (2..8) shared-memory buffers filled by asynchronous copies; NX must be
    a multiple of r, a tile (r * NY * itemsize bytes) a multiple of 16
    bytes, and stages tiles must fit a block's shared memory, else
    ValueError. On CUDA tensors it launches the kernel on the current
    stream and counts it in LAUNCHES; on CPU tensors it writes
    copy_reference's result."""
    check_device(src)
    if src.dtype not in (torch.float32, torch.bfloat16) or src.dim() != 3 or \
            src.shape[0] != NSPEEDS or src.numel() == 0:
        raise ValueError(f"src must be a float32 or bfloat16 (9, NX, NY) state, got "
                         f"{src.dtype} {tuple(src.shape)}")
    if dst.dtype != src.dtype or dst.shape != src.shape or dst.device != src.device:
        raise ValueError(f"dst must be {src.dtype} {tuple(src.shape)} on {src.device}, got "
                         f"{dst.dtype} {tuple(dst.shape)} on {dst.device}")
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("src and dst must be contiguous")
    if src.data_ptr() == dst.data_ptr():
        raise ValueError("src and dst must be distinct buffers")
    n_bytes = src.numel() * src.element_size()
    tile_bytes = 0
    if ctas_per_sm is not None and (rows is not None or not isinstance(ctas_per_sm, int)
                                    or not 1 <= ctas_per_sm <= 64):
        raise ValueError(f"ctas_per_sm is 1..64 and belongs to the direct form, got "
                         f"{ctas_per_sm!r} with rows={rows!r}")
    if rows is not None:
        nx, ny = src.shape[1], src.shape[2]
        tile_bytes = rows * ny * src.element_size() if isinstance(rows, int) else 0
        if not isinstance(rows, int) or rows < 1 or nx % rows != 0:
            raise ValueError(f"rows must divide NX = {nx}, got {rows!r}")
        if not isinstance(stages, int) or not 2 <= stages <= MAX_STAGES:
            raise ValueError(f"stages must be 2..{MAX_STAGES}, got {stages!r}")
        if tile_bytes % 16 != 0:
            raise ValueError(f"a tile of {rows} rows of {ny} {src.dtype} values is "
                             f"{tile_bytes} bytes, no multiple of 16: the staged form moves "
                             "16-byte vectors (the direct form takes any NY)")
        if stages * tile_bytes > MAX_SHARED_BYTES:
            raise ValueError(f"{stages} stages of {tile_bytes} bytes exceed a block's "
                             f"{MAX_SHARED_BYTES} bytes of shared memory")
    if src.device.type == "cpu":
        dst.copy_(copy_reference(src))
        return dst
    rc = cuda_build.load_library().lbm_copy_launch(
        src.data_ptr(), dst.data_ptr(), n_bytes, tile_bytes, stages, ctas_per_sm or 0,
        _stream(src))
    _raise_on(rc, "lbm_copy")
    LAUNCHES["copy-staged" if tile_bytes else "copy-direct"] += 1
    return dst


# ---------------------------------------------------------------- y roll


def roll_y_reference(x: torch.Tensor, shift: int, n_rolls: int) -> torch.Tensor:
    """Plain PyTorch version of the y-roll kernel: n_rolls chained
    torch.roll(v, shift, 1), the body of the JAX probe
    (scripts/anatomy.py:186-190 there)."""
    v = x.clone()
    for _ in range(n_rolls):
        v = torch.roll(v, shift, 1)
    return v


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _cluster_takes(ny: int) -> bool:
    """NY splits into ROLL_Y_CLUSTER segments of whole 16-byte vectors, and
    a CTA's two buffers and four mbarriers fit its shared memory
    (csrc/lbm_probes.cu: roll_y_cluster_shared)."""
    c = ROLL_Y_CLUSTER
    return ny % (4 * c) == 0 and 2 * (ny // 4 // c + 1) * 16 + 32 <= MAX_SHARED_BYTES


def _roll_form(kind: str, form: str | None, takes: bool, why: str) -> str:
    """The form of a shared-memory roll: `form`, or for None
    DEFAULT_FORM[kind] where the wide form takes the shape (takes) and
    "narrow" elsewhere; "wide" where it does not take the shape raises
    ValueError (why: what it needs)."""
    if form not in (None, *FORMS):
        raise ValueError(f"form must be None or one of {FORMS}, got {form!r}")
    if form == "wide" and not takes:
        raise ValueError(f"the wide {kind} takes {why}")
    return form or (DEFAULT_FORM[kind] if takes else "narrow")


def roll_y(x: torch.Tensor, shift: int, n_rolls: int, *, mechanism: str = "shared",
           form: str | None = None, out: torch.Tensor | None = None) -> torch.Tensor:
    """n_rolls chained periodic shifts of x by `shift` along y; returns a
    new (rows, NY) block (or `out`). mechanism "shared" moves each row
    through shared memory, in one of two forms: "wide" splits it across a
    cluster of ROLL_Y_CLUSTER CTAs and moves 16-byte vectors, and takes NY
    a multiple of 4 * ROLL_Y_CLUSTER and 16-byte aligned x and out, else
    ValueError; "narrow" takes a row per CTA and any NY; form=None is
    DEFAULT_FORM["roll_y"], the narrow one. "shuffle" keeps each row in
    registers and shifts by warp shuffles, and takes only a shift within
    31 columns of 0 either way (and not 0) on rows of at most 8192
    columns, and no form, else ValueError. On a CUDA tensor it launches
    the kernel and counts it in LAUNCHES (and its form in
    ROLL_FORM_LAUNCHES); on a CPU tensor it returns roll_y_reference's
    result."""
    _check_block(x)
    if mechanism not in _ROLL_Y:
        raise ValueError(f"mechanism must be one of {sorted(_ROLL_Y)}, got {mechanism!r}")
    n_rolls = _count(n_rolls, "n_rolls")
    rows, ny = x.shape
    s = int(shift) % ny
    if mechanism == "shuffle":
        if form is not None:
            raise ValueError("form belongs to the shared-memory mechanism")
        if min(s, ny - s) > SHUFFLE_MAX_SHIFT or s == 0 or ny > SHUFFLE_MAX_NY:
            raise ValueError(
                f"the shuffle mechanism takes a non-zero shift within {SHUFFLE_MAX_SHIFT} "
                f"columns of 0 on rows of at most {SHUFFLE_MAX_NY} columns; got shift "
                f"{shift} on NY = {ny}")
    elif 2 * ny * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"a row of {ny} columns does not fit a block's shared memory twice")
    out = _out_like(x, out, x.shape)
    if mechanism == "shared":
        form = _roll_form("roll_y", form, _cluster_takes(ny) and _aligned(x, out),
                          f"NY a multiple of {4 * ROLL_Y_CLUSTER} and 16-byte aligned blocks; "
                          f"got NY = {ny}")
    if x.device.type == "cpu":
        out.copy_(roll_y_reference(x, shift, n_rolls))
        return out
    lib = cuda_build.load_library()
    if form == "wide":
        rc = lib.lbm_roll_y_wide_launch(x.data_ptr(), out.data_ptr(), rows, ny, s, n_rolls,
                                        _stream(x))
    else:
        rc = lib.lbm_roll_y_launch(x.data_ptr(), out.data_ptr(), rows, ny, s, n_rolls,
                                   _ROLL_Y[mechanism], _stream(x))
    _raise_on(rc, "lbm_roll_y" + ("_wide" if form == "wide" else ""))
    LAUNCHES[f"roll_y-{mechanism}"] += 1
    if form is not None:
        ROLL_FORM_LAUNCHES[f"roll_y-{form}"] += 1
    return out


def roll_y_clusters(rows: int, ny: int) -> int:
    """cudaOccupancyMaxActiveClusters of the wide y-roll's launch at (rows,
    NY); raises ValueError where the form does not take NY and
    RuntimeError if the query fails. Card only."""
    if not _cluster_takes(ny):
        raise ValueError(f"the wide y-roll does not take NY = {ny}")
    active = ctypes.c_int64(0)
    rc = cuda_build.load_library().lbm_roll_y_wide_clusters(rows, ny, ctypes.byref(active))
    _raise_on(rc, "cudaOccupancyMaxActiveClusters")
    return active.value


# ----------------------------------------------------------------- align


def align_reference(x: torch.Tensor, offset: int, n_ops: int, axis: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the alignment kernel: the body of the JAX
    probe (scripts/anatomy.py:216-222 there) along `axis`: a = x[o:R-2+o],
    b = x[2-o:R-o], v = a, then n_ops times v = v + b, in order."""
    x = x if axis == 0 else x.t()
    r = x.shape[0]
    a = x[offset: r - 2 + offset]
    b = x[2 - offset: r - offset]
    v = a.clone()
    for _ in range(n_ops):
        v = v + b
    return (v if axis == 0 else v.t()).contiguous()


def align(x: torch.Tensor, offset: int, n_ops: int, *, axis: int = 0,
          out: torch.Tensor | None = None) -> torch.Tensor:
    """n_ops chained adds on two windows of x offset by `offset` (0, 1, 2)
    along `axis`: 0 is rows, the JAX probe as written, giving (R - 2, NY);
    1 is columns, giving (R, NY - 2). On a CUDA tensor it launches the
    kernel and counts it in LAUNCHES; on a CPU tensor it returns
    align_reference's result."""
    _check_block(x)
    if axis not in (0, 1) or offset not in (0, 1, 2):
        raise ValueError(f"axis must be 0 or 1 and offset 0, 1 or 2; got {axis!r}, {offset!r}")
    n_ops = _count(n_ops, "n_ops")
    rows, ny = x.shape
    if x.shape[axis] < 3:
        raise ValueError(f"the windows need 3 or more along axis {axis}, got {tuple(x.shape)}")
    shape = (rows - 2, ny) if axis == 0 else (rows, ny - 2)
    out = _out_like(x, out, shape)
    if x.device.type == "cpu":
        out.copy_(align_reference(x, offset, n_ops, axis))
        return out
    rc = cuda_build.load_library().lbm_align_launch(
        x.data_ptr(), out.data_ptr(), rows, ny, offset, n_ops, axis, _stream(x))
    _raise_on(rc, "lbm_align")
    LAUNCHES[f"align-axis{axis}"] += 1
    return out


# ---------------------------------------------------------------- x roll


def roll_x_reference(x: torch.Tensor, shift: int, n_rolls: int) -> torch.Tensor:
    """Plain PyTorch version of the x-roll kernel: n_rolls chained
    torch.roll(v, shift, 0), the body of the JAX probe
    (scripts/anatomy.py:246-250 there)."""
    v = x.clone()
    for _ in range(n_rolls):
        v = torch.roll(v, shift, 0)
    return v


def roll_x(x: torch.Tensor, shift: int, n_rolls: int, *, mechanism: str = "shared",
           form: str | None = None, out: torch.Tensor | None = None) -> torch.Tensor:
    """n_rolls chained periodic shifts of x by `shift` along x (rows);
    returns a new (R, NY) block (or `out`). mechanism "shared" holds each
    column tile's rows in shared memory, in one of two forms: "wide"
    moves 16-byte vectors on one-warp CTAs of ROLL_X_VECTORS vectors, and
    takes NY a multiple of 4 and 16-byte aligned x and out, else
    ValueError; "narrow" takes 128-column tiles and any NY; form=None
    picks DEFAULT_FORM["roll_x"], the wide one, wherever it applies.
    "global" re-reads the rows from global memory each roll (through two
    scratch blocks it allocates) and takes no form.
    On a CUDA tensor it launches the kernel and counts it in LAUNCHES (and
    its form in ROLL_FORM_LAUNCHES); on a CPU tensor it returns
    roll_x_reference's result."""
    _check_block(x)
    if mechanism not in _ROLL_X:
        raise ValueError(f"mechanism must be one of {sorted(_ROLL_X)}, got {mechanism!r}")
    n_rolls = _count(n_rolls, "n_rolls")
    rows, ny = x.shape
    if mechanism == "shared" and 2 * rows * 128 * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"{rows} rows of a 128-column tile do not fit a block's shared "
                         "memory twice")
    out = _out_like(x, out, x.shape)
    if mechanism == "global":
        if form is not None:
            raise ValueError("form belongs to the shared-memory mechanism")
    else:
        form = _roll_form("roll_x", form, ny % 4 == 0 and _aligned(x, out),
                          f"NY a multiple of 4 and 16-byte aligned blocks; got NY = {ny}")
    if x.device.type == "cpu":
        out.copy_(roll_x_reference(x, shift, n_rolls))
        return out
    lib = cuda_build.load_library()
    if form == "wide":
        rc = lib.lbm_roll_x_wide_launch(x.data_ptr(), out.data_ptr(), rows, ny,
                                        int(shift) % rows, n_rolls, _stream(x))
    else:
        scratch = ([torch.empty_like(x), torch.empty_like(x)] if mechanism == "global"
                   else [None] * 2)
        rc = lib.lbm_roll_x_launch(
            x.data_ptr(), out.data_ptr(), *(None if t is None else t.data_ptr() for t in scratch),
            rows, ny, int(shift) % rows, n_rolls, _ROLL_X[mechanism], _stream(x))
    _raise_on(rc, "lbm_roll_x" + ("_wide" if form == "wide" else ""))
    LAUNCHES[f"roll_x-{mechanism}"] += 1
    if form is not None:
        ROLL_FORM_LAUNCHES[f"roll_x-{form}"] += 1
    return out
