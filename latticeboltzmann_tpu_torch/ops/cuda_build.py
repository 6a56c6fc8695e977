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
SOURCES = ("lbm_step.cu", "lbm_ds_step.cu")
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
    """build/lbm_torch_kernels/<hash of the sources and flags>/."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
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
    fn = lib.lbm_stream_collide_f32_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # src
        ctypes.c_void_p,  # dst
        ctypes.c_void_p,  # solid (may be null for the wall-free variant)
        ctypes.c_int64,   # nx
        ctypes.c_int64,   # ny
        ctypes.c_int64,   # has_walls
        ctypes.c_void_p,  # params: 9 host floats
        ctypes.c_void_p,  # cudaStream_t
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
        ctypes.c_void_p,  # params: 20 (exact) or 30 (fast) host floats
        ctypes.c_void_p,  # cudaStream_t
    ]
    return lib
