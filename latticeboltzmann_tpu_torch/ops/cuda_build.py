"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources in csrc/ compile into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), cached under
build/lbm_torch_kernels/<source-hash>/ in the repository root and built
at first use: one nvcc per source, all started together, then one link.
Nothing here runs at import time. Unlike the JAX package's
utils/native.py, a failed build raises: there is no fallback behind a
CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("lbm_step.cu", "lbm_wide_step.cu", "lbm_wide_ext_step.cu", "lbm_ds_step.cu",
           "lbm_ds_temporal_step.cu", "lbm_flat_step.cu", "lbm_temporal_step.cu",
           "lbm_temporal_rdma_step.cu", "lbm_probes.cu")
# included by the sources (each from its own directory); hashed with them
HEADERS = ("lbm_collide.cuh", "lbm_ds.cuh", "lbm_ext.cuh", "lbm_temporal.cuh", "lbm_tile.cuh",
           "lbm_wide.cuh")
LIB_NAME = "liblbm_kernels.so"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
# sm_90a keeps Hopper-only instructions available; -fmad=false and no
# fast math keep every product and division singly rounded, so the
# kernels round exactly like their plain PyTorch versions (the ds kernel
# also writes every op as an _rn intrinsic, so it does not depend on
# -fmad=false)
NVCC_FLAGS = (
    *GENCODE, "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


DEFAULT_CUDA_HOME = "/usr/local/cuda"


def find_nvcc() -> str:
    """nvcc from PATH, else from CUDA_HOME or DEFAULT_CUDA_HOME; raises
    RuntimeError when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are built from csrc/ at first use and need the CUDA toolkit"
    )


def build_dir() -> pathlib.Path:
    """build/lbm_torch_kernels/<hash of the sources, headers and flags>/."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return _PKG.parent / "build" / "lbm_torch_kernels" / h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[tuple[list[str], int, str]]:
    """Run the commands side by side; (command, exit code, output) each.
    Every process is ended before this returns."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
        return [(c, p.returncode, out) for c, p, out in zip(cmds, procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def build() -> pathlib.Path:
    """Compile the library unless this source hash is already built;
    returns its path. nvcc's output (with -Xptxas -v's register and
    spill report) is kept beside it as nvcc.log."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), os.getpid()
    objs = [out_dir / f"{pathlib.Path(s).stem}.{tag}.o" for s in SOURCES]
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                        for s, o in zip(SOURCES, objs)])
    if all(rc == 0 for _, rc, _ in results):
        results += _run_all([[nvcc, *GENCODE, "-shared", "-o", str(tmp), *map(str, objs)]])
    log = "".join(" ".join(c) + "\n" + out for c, _, out in results)
    (out_dir / "nvcc.log").write_text(log)
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [rc for _, rc, _ in results if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {failed[0]}:\n{log}")
    os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library, with every
    entry point's argument and return types declared."""
    lib = ctypes.CDLL(str(build()))
    fn = lib.lbm_stream_collide_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # src
        ctypes.c_void_p,  # dst
        ctypes.c_void_p,  # solid class plane (null unless geometry 1)
        ctypes.c_void_p,  # spec: 10 host int64 (null unless geometry 2)
        ctypes.c_int64,   # nx
        ctypes.c_int64,   # ny
        ctypes.c_int64,   # storage: 0 float32, 1 bfloat16
        ctypes.c_int64,   # geometry: 0 none, 1 plane, 2 spec
        ctypes.c_int64,   # fast_math
        ctypes.c_void_p,  # params: 9 host floats
        ctypes.c_void_p,  # cudaStream_t
    ]
    # the wide form takes the same arguments
    lib.lbm_stream_collide_wide_launch.restype = ctypes.c_int
    lib.lbm_stream_collide_wide_launch.argtypes = fn.argtypes
    lib.lbm_wide_columns.restype = ctypes.c_int64
    lib.lbm_wide_columns.argtypes = [ctypes.c_int64]  # storage: 0 float32, 1 bfloat16
    fn = lib.lbm_stream_collide_ext_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # src: the shard's (9, nx, ny) block
        ctypes.c_void_p,  # dst
        ctypes.c_void_p,  # top halo row (9, ny), or null
        ctypes.c_void_p,  # bot halo row (9, ny), or null
        ctypes.c_void_p,  # solid class plane (null unless geometry 1)
        ctypes.c_void_p,  # top halo class row (ny), or null
        ctypes.c_void_p,  # bot halo class row (ny), or null
        ctypes.c_void_p,  # spec: 10 host int64 (null unless geometry 2)
        ctypes.c_int64,   # nx: the shard's rows
        ctypes.c_int64,   # ny
        ctypes.c_int64,   # row0: first row written
        ctypes.c_int64,   # rows written
        ctypes.c_int64,   # offset: global row of local row 0
        ctypes.c_int64,   # gnx: global rows
        ctypes.c_int64,   # storage: 0 float32, 1 bfloat16
        ctypes.c_int64,   # geometry: 0 none, 1 plane, 2 spec
        ctypes.c_int64,   # fast_math
        ctypes.c_void_p,  # params: 9 host floats
        ctypes.c_void_p,  # cudaStream_t
    ]
    # the ext-halo form's wide kernel takes the same arguments
    lib.lbm_stream_collide_ext_wide_launch.restype = ctypes.c_int
    lib.lbm_stream_collide_ext_wide_launch.argtypes = fn.argtypes
    fn = lib.lbm_stream_collide_rdma_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # src: the shard's (9, nx, ny) block
        ctypes.c_void_p,  # dst
        ctypes.c_void_p,  # top: this shard's (2, 9, ny) comm rows, by step parity
        ctypes.c_void_p,  # bot
        ctypes.c_void_p,  # up_bot: the upper neighbour's bot rows (2, 9, ny)
        ctypes.c_void_p,  # down_top: the lower neighbour's top rows (2, 9, ny)
        ctypes.c_void_p,  # flags: this shard's [top, bot] flag words (uint64)
        ctypes.c_void_p,  # up_flag: the upper neighbour's bot flag word
        ctypes.c_void_p,  # down_flag: the lower neighbour's top flag word
        ctypes.c_void_p,  # work: this shard's [ticket counter, error word] (uint64)
        ctypes.c_void_p,  # solid class plane (null unless geometry 1)
        ctypes.c_void_p,  # top halo class row (ny), or null
        ctypes.c_void_p,  # bot halo class row (ny), or null
        ctypes.c_void_p,  # spec: 10 host int64 (null unless geometry 2)
        ctypes.c_int64,   # nx: the shard's rows (at least 3)
        ctypes.c_int64,   # ny
        ctypes.c_int64,   # offset: global row of local row 0
        ctypes.c_int64,   # gnx: global rows
        ctypes.c_int64,   # storage: 0 float32, 1 bfloat16
        ctypes.c_int64,   # geometry: 0 none, 1 plane, 2 spec
        ctypes.c_int64,   # fast_math
        ctypes.c_void_p,  # params: 9 host floats
        ctypes.c_int64,   # step: 1, 2, ... since the flags were zeroed
        ctypes.c_int64,   # timeout_ns: bound of an edge row's wait
        ctypes.c_void_p,  # cudaStream_t
    ]
    # the rdma form's wide kernel takes the same arguments
    lib.lbm_stream_collide_rdma_wide_launch.restype = ctypes.c_int
    lib.lbm_stream_collide_rdma_wide_launch.argtypes = fn.argtypes
    fn = lib.lbm_enable_peer_access
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int64,  # device whose kernels reach out
        ctypes.c_int64,  # peer whose memory they address
    ]
    fn = lib.lbm_stream_collide_ds_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # src_hi
        ctypes.c_void_p,  # src_lo
        ctypes.c_void_p,  # dst_hi
        ctypes.c_void_p,  # dst_lo
        ctypes.c_void_p,  # solid (may be null for the wall-free variant)
        ctypes.c_int64,   # nx
        ctypes.c_int64,   # ny
        ctypes.c_int64,   # has_walls
        ctypes.c_int64,   # exact
        ctypes.c_void_p,  # params: 20 (exact) or 18 (fast) host floats
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn = lib.lbm_stream_collide_ds_ext_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # src_hi: the shard's (9, nx, ny) blocks
        ctypes.c_void_p,  # src_lo
        ctypes.c_void_p,  # dst_hi
        ctypes.c_void_p,  # dst_lo
        ctypes.c_void_p,  # top_hi: halo rows (9, ny), or null
        ctypes.c_void_p,  # top_lo
        ctypes.c_void_p,  # bot_hi
        ctypes.c_void_p,  # bot_lo
        ctypes.c_void_p,  # solid (may be null for the wall-free variant)
        ctypes.c_void_p,  # top halo class row (ny), or null
        ctypes.c_void_p,  # bot halo class row (ny), or null
        ctypes.c_int64,   # nx: the shard's rows
        ctypes.c_int64,   # ny
        ctypes.c_int64,   # row0: first row written
        ctypes.c_int64,   # rows written
        ctypes.c_int64,   # has_walls
        ctypes.c_int64,   # exact
        ctypes.c_void_p,  # params: 20 (exact) or 18 (fast) host floats
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn = lib.lbm_ds_temporal_steps_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # src_hi
        ctypes.c_void_p,  # src_lo
        ctypes.c_void_p,  # dst_hi
        ctypes.c_void_p,  # dst_lo
        ctypes.c_void_p,  # solid (may be null for the wall-free variant)
        ctypes.c_int64,   # nx
        ctypes.c_int64,   # ny: a multiple of 4
        ctypes.c_int64,   # has_walls
        ctypes.c_int64,   # exact
        ctypes.c_int64,   # steps of the pass
        ctypes.c_void_p,  # params: 20 (exact) or 18 (fast) host floats
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn = lib.lbm_ds_temporal_steps_info
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int64,   # exact
        ctypes.c_int64,   # has_walls
        ctypes.c_void_p,  # out: 6 int64 (registers, CTAs per SM, shared bytes, local bytes,
                          # the tile's rows and columns)
    ]
    fn = lib.lbm_ds_temporal_steps_ext_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # src_hi: the shard's (9, nx, ny) blocks
        ctypes.c_void_p,  # src_lo
        ctypes.c_void_p,  # dst_hi
        ctypes.c_void_p,  # dst_lo
        ctypes.c_void_p,  # top_hi: (9, depth, ny), the rows above the shard, or null
        ctypes.c_void_p,  # top_lo
        ctypes.c_void_p,  # bot_hi: (9, depth, ny), the rows below the shard, or null
        ctypes.c_void_p,  # bot_lo
        ctypes.c_void_p,  # solid (may be null for the wall-free variant)
        ctypes.c_void_p,  # top halo class rows (depth, ny), or null
        ctypes.c_void_p,  # bot halo class rows (depth, ny), or null
        ctypes.c_int64,   # nx: the shard's rows
        ctypes.c_int64,   # ny: a multiple of 4
        ctypes.c_int64,   # depth: the halos' rows (0 without halos)
        ctypes.c_int64,   # row0: first row written
        ctypes.c_int64,   # rows written
        ctypes.c_int64,   # has_walls
        ctypes.c_int64,   # exact
        ctypes.c_int64,   # steps of the pass
        ctypes.c_void_p,  # params: 20 (exact) or 18 (fast) host floats
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn = lib.lbm_ds_temporal_steps_ext_info
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int64,   # exact
        ctypes.c_int64,   # has_walls
        ctypes.c_void_p,  # out: 6 int64, as lbm_ds_temporal_steps_info's
    ]
    fn = lib.lbm_flat_steps_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # f2: the stacked (2, 9, nx, ny) pair, in place
        ctypes.c_int64,   # nx
        ctypes.c_int64,   # ny
        ctypes.c_int64,   # storage: 0 float32, 1 bfloat16
        ctypes.c_int64,   # fast_math
        ctypes.c_void_p,  # plan: 8 host int64, steps and count of each run of passes
        ctypes.c_int64,   # vec: 16-byte loads and stores
        ctypes.c_int64,   # blocks: 0 for the co-resident grid
        ctypes.c_void_p,  # params: 9 host floats
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn = lib.lbm_flat_steps_info
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int64,   # storage: 0 float32, 1 bfloat16
        ctypes.c_void_p,  # out: 6 int64 (registers, CTAs per SM, shared bytes, local bytes,
                          # the tile's rows and columns)
    ]
    fn = lib.lbm_temporal_steps_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # src
        ctypes.c_void_p,  # dst
        ctypes.c_void_p,  # solid: uint8 class plane (geometry 1), or null
        ctypes.c_void_p,  # spec: 10 host int64 (geometry 2), or null
        ctypes.c_int64,   # nx
        ctypes.c_int64,   # ny
        ctypes.c_int64,   # storage: 0 float32, 1 bfloat16
        ctypes.c_int64,   # geometry: 0 none, 1 plane, 2 spec
        ctypes.c_int64,   # fast_math
        ctypes.c_int64,   # steps of the pass
        ctypes.c_void_p,  # params: 9 host floats
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn = lib.lbm_temporal_steps_info
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int64,   # storage: 0 float32, 1 bfloat16
        ctypes.c_int64,   # geometry: 0 none, 1 plane, 2 spec
        ctypes.c_void_p,  # out: 8 int64 (registers, CTAs per SM, shared bytes, local bytes,
                          # the tile's rows and columns, the CTA's threads and tile buffers)
    ]
    # the shard's forms of the temporal kernel take the same info arguments
    for name in ("lbm_temporal_steps_ext_info", "lbm_temporal_steps_rdma_info"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = fn.argtypes
    fn = lib.lbm_temporal_steps_ext_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int64,   # storage: 0 float32, 1 bfloat16
        ctypes.c_int64,   # geometry: 0 none, 1 plane, 2 spec
        ctypes.c_int64,   # rows: the launch's output rows
        ctypes.c_int64,   # ny
        ctypes.c_int64,   # steps of the pass
        ctypes.c_int64,   # tile_rows: 0 for the plan's tile
        ctypes.c_void_p,  # out: 4 int64 (the tile's rows, tiles, CTAs, waves)
    ]
    fn = lib.lbm_temporal_steps_ext_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # src: the shard's (9, nx, ny) block
        ctypes.c_void_p,  # dst
        ctypes.c_void_p,  # top: (9, depth, ny), the rows above local row 0 (or null)
        ctypes.c_void_p,  # bot: (9, depth, ny), the rows below local row nx - 1 (or null)
        ctypes.c_void_p,  # solid: the shard's uint8 class plane (geometry 1), or null
        ctypes.c_void_p,  # solid_top: top's (depth, ny) class rows (geometry 1), or null
        ctypes.c_void_p,  # solid_bot
        ctypes.c_void_p,  # spec: 10 host int64 (geometry 2), or null
        ctypes.c_int64,   # nx: the shard's rows
        ctypes.c_int64,   # ny
        ctypes.c_int64,   # depth: the halos' rows
        ctypes.c_int64,   # row0: first local row written
        ctypes.c_int64,   # rows written
        ctypes.c_int64,   # offset: global row of local row 0
        ctypes.c_int64,   # gnx: global rows
        ctypes.c_int64,   # storage: 0 float32, 1 bfloat16
        ctypes.c_int64,   # geometry: 0 none, 1 plane, 2 spec
        ctypes.c_int64,   # fast_math
        ctypes.c_int64,   # steps of the pass
        ctypes.c_void_p,  # params: 9 host floats
        ctypes.c_int64,   # tile_rows: 0 for the plan's tile
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn = lib.lbm_temporal_steps_rdma_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # src: the shard's (9, nx, ny) block
        ctypes.c_void_p,  # dst
        ctypes.c_void_p,  # top: this shard's (2, 9, depth, ny) comm block above
        ctypes.c_void_p,  # bot: below
        ctypes.c_void_p,  # up_bot: the upper neighbour's bot block
        ctypes.c_void_p,  # down_top: the lower neighbour's top block
        ctypes.c_void_p,  # flags: this shard's [top, bot] flag words
        ctypes.c_void_p,  # up_flag: the upper neighbour's bot flag word
        ctypes.c_void_p,  # down_flag: the lower neighbour's top flag word
        ctypes.c_void_p,  # work: this shard's launch words
        ctypes.c_void_p,  # solid: the shard's uint8 class plane (geometry 1), or null
        ctypes.c_void_p,  # solid_top: the (depth, ny) class rows above (geometry 1), or null
        ctypes.c_void_p,  # solid_bot
        ctypes.c_void_p,  # spec: 10 host int64 (geometry 2), or null
        ctypes.c_int64,   # nx: the shard's rows
        ctypes.c_int64,   # ny
        ctypes.c_int64,   # depth: the comm blocks' rows
        ctypes.c_int64,   # offset: global row of local row 0
        ctypes.c_int64,   # gnx: global rows
        ctypes.c_int64,   # storage: 0 float32, 1 bfloat16
        ctypes.c_int64,   # geometry: 0 none, 1 plane, 2 spec
        ctypes.c_int64,   # fast_math
        ctypes.c_int64,   # steps of the pass
        ctypes.c_void_p,  # params: 9 host floats
        ctypes.c_int64,   # pass: 1, 2, ... since the flags were zeroed
        ctypes.c_int64,   # timeout_ns of an edge CTA's wait
        ctypes.c_int64,   # card_shards: the ring's launches on this card
        ctypes.c_int64,   # tile_rows: 0 for the plan's tile
        ctypes.c_void_p,  # cudaStream_t
    ]
    lib.lbm_temporal_steps_rdma_words.restype = ctypes.c_int64
    lib.lbm_temporal_steps_rdma_words.argtypes = []
    fn = lib.lbm_temporal_steps_rdma_grid
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int64,   # storage: 0 float32, 1 bfloat16
        ctypes.c_int64,   # geometry: 0 none, 1 plane, 2 spec
        ctypes.c_int64,   # nx: the shard's rows
        ctypes.c_int64,   # ny
        ctypes.c_int64,   # steps of the pass
        ctypes.c_int64,   # card_shards
        ctypes.c_int64,   # tile_rows: 0 for the plan's tile
        ctypes.c_void_p,  # out: 5 int64 (CTAs, interior tiles, edge tiles, the tile's
                          # rows, waves)
    ]
    fn = lib.lbm_copy_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # src
        ctypes.c_void_p,  # dst
        ctypes.c_int64,   # n_bytes
        ctypes.c_int64,   # tile_bytes: 0 for the direct form
        ctypes.c_int64,   # stages (staged form)
        ctypes.c_int64,   # ctas_per_sm (direct form): 0 covers the buffer
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn = lib.lbm_roll_y_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # x: (rows, ny) float32
        ctypes.c_void_p,  # out
        ctypes.c_int64,   # rows
        ctypes.c_int64,   # ny
        ctypes.c_int64,   # shift in [0, ny)
        ctypes.c_int64,   # n_rolls
        ctypes.c_int64,   # mechanism: 0 shared memory, 1 warp shuffles
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn = lib.lbm_align_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # x: (rows, ny) float32
        ctypes.c_void_p,  # out: (rows - 2, ny) or (rows, ny - 2)
        ctypes.c_int64,   # rows
        ctypes.c_int64,   # ny
        ctypes.c_int64,   # offset: 0, 1, 2
        ctypes.c_int64,   # n_ops
        ctypes.c_int64,   # axis: 0 rows, 1 columns
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn = lib.lbm_roll_x_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # x: (rows, ny) float32
        ctypes.c_void_p,  # out
        ctypes.c_void_p,  # scratch0 (mechanism 1), or null
        ctypes.c_void_p,  # scratch1 (mechanism 1), or null
        ctypes.c_int64,   # rows
        ctypes.c_int64,   # ny
        ctypes.c_int64,   # shift in [0, rows)
        ctypes.c_int64,   # n_rolls
        ctypes.c_int64,   # mechanism: 0 shared memory, 1 global re-reads
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn = lib.lbm_roll_x_wide_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # x: (rows, ny) float32, 16-byte aligned
        ctypes.c_void_p,  # out
        ctypes.c_int64,   # rows
        ctypes.c_int64,   # ny: a multiple of 4
        ctypes.c_int64,   # shift in [0, rows)
        ctypes.c_int64,   # n_rolls
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn = lib.lbm_roll_y_wide_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # x: (rows, ny) float32, 16-byte aligned
        ctypes.c_void_p,  # out
        ctypes.c_int64,   # rows
        ctypes.c_int64,   # ny: a multiple of 16 (4 CTAs per row)
        ctypes.c_int64,   # shift in [0, ny)
        ctypes.c_int64,   # n_rolls
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn = lib.lbm_roll_y_wide_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int64,   # rows
        ctypes.c_int64,   # ny
        ctypes.c_void_p,  # out: one int64, cudaOccupancyMaxActiveClusters
    ]
    return lib
