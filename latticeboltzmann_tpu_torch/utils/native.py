"""ctypes bindings to the native C++ IO runtime (native/lbm_io.cpp), the
port's copy of latticeboltzmann_tpu/utils/native.py.

The shared library is built with g++ at first use into
build/lbm_io/<hash of the source>/ in the repository root (nothing is
written beside the source). Only the CSV writer goes through it, with a
pure-NumPy path that writes the same bytes, taken on a machine without
g++ and inside numpy_only(). Raw files are a plain copy of the array's
bytes, which ndarray.tofile and np.fromfile make as fast as the C++
entry points, so they stay in NumPy. This is host IO: nothing here
touches a device.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "lbm_io.cpp"
_lock = threading.Lock()
_lib = None
_tried = False
_numpy_only = False


def library_path() -> pathlib.Path:
    """build/lbm_io/<hash of the source>/lbm_io.so: a changed source
    builds anew, and an unchanged one is built once per checkout."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _PKG.parent / "build" / "lbm_io" / digest / "lbm_io.so"


def _build(so: pathlib.Path) -> bool:
    """g++ into a temporary file beside `so`, then an atomic rename, so
    that processes building at once never load a half-written library."""
    try:
        so.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, str(_SRC)],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return True
    except Exception:
        return False


def _load():
    global _lib, _tried
    if _numpy_only:
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
            lib.lbm_write_csv.restype = ctypes.c_int
            lib.lbm_write_csv.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.c_int64,
            ]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


@contextlib.contextmanager
def numpy_only():
    """Within the block write_csv takes its NumPy path, as on a machine
    without g++ (to compare or time the two paths)."""
    global _numpy_only
    before = _numpy_only
    _numpy_only = True
    try:
        yield
    finally:
        _numpy_only = before


def write_csv(path: str, data: np.ndarray) -> None:
    """One row per lattice row, '%.10f' values, ', '-separated."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.float64)
    if lib is None:
        with open(path, "w") as fp:
            for row in data:
                fp.write(", ".join(f"{v:.10f}" for v in row))
                fp.write("\n")
        return
    rc = lib.lbm_write_csv(
        path.encode(),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        data.shape[0],
        data.shape[1],
    )
    if rc != 0:
        raise IOError(f"lbm_write_csv({path}) failed with code {rc}")


def write_raw(path: str, data: np.ndarray) -> None:
    np.ascontiguousarray(data).tofile(path)


def read_raw(path: str, shape, dtype) -> np.ndarray:
    return np.fromfile(path, dtype=dtype).reshape(shape)
