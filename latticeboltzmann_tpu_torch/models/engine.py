"""Simulation facade: twin of latticeboltzmann_tpu/models/engine.py for
the port's backends.

- "torch": the portable engine (ops/stream_collide.py) on any device,
  the counterpart of "xla".
- "cuda": a persistent ops/fused_kernel.Session around the hand-written
  CUDA kernel, the counterpart of "pallas". It raises without a CUDA
  card, and on dtypes the kernel does not take yet; it never reroutes.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..core import geometry
from ..core.spec import NSPEEDS, W, LatticeConfig
from ..ops import fused_kernel
from ..ops import stream_collide as torch_ops
from ..utils.interop import to_numpy, torch_dtype

# backend name -> run_steps(f, walls, cfg, n_steps) -> f
_BACKENDS: dict[str, Callable] = {}


def register_backend(name: str, run_steps: Callable) -> None:
    _BACKENDS[name] = run_steps


register_backend("torch", torch_ops.run_steps)
register_backend("cuda", fused_kernel.run_steps)


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


def initial_state(cfg: LatticeConfig) -> np.ndarray:
    """Rest-equilibrium initial fill (src/latticeboltzmann.c:583-591)."""
    f = np.empty((NSPEEDS, cfg.nx, cfg.ny), dtype=np.dtype(cfg.dtype))
    rho = np.asarray(cfg.initial_density, dtype=np.dtype(cfg.dtype))
    for s in range(NSPEEDS):
        f[s] = rho * np.asarray(W[s], dtype=np.dtype(cfg.dtype))
    return f


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Simulation:
    """A running lattice. `backend` selects the compute path ("torch" or
    "cuda", see the module docstring); `device` defaults to "cuda" for
    the cuda backend and "cpu" for the torch backend."""

    def __init__(
        self,
        cfg: LatticeConfig,
        walls: np.ndarray | None = None,
        *,
        backend: str = "torch",
        device: str | torch.device | None = None,
        f0: np.ndarray | None = None,
    ):
        self.cfg = cfg
        dtype = torch_dtype(cfg.dtype)  # raises on what the port does not take
        if walls is None:
            walls = geometry.channel_with_barrier(cfg.nx, cfg.ny)
        if walls.shape != (cfg.nx, cfg.ny):
            raise ValueError(f"walls shape {walls.shape} != lattice {(cfg.nx, cfg.ny)}")
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; have {available_backends()}")
        if device is None:
            device = "cuda" if backend == "cuda" else "cpu"
        self.device = torch.device(device)
        if backend == "cuda" and self.device.type != "cuda":
            raise ValueError(f"backend 'cuda' runs on a CUDA device, not {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"backend {backend!r} on {self.device} needs a CUDA card, and "
                "torch.cuda.is_available() is False (use backend='torch' on the CPU)"
            )
        self.backend = backend
        self._run_steps = _BACKENDS[backend]
        self.walls_np = np.asarray(walls, dtype=bool)
        self.walls = torch.as_tensor(self.walls_np, device=self.device)
        f_init = initial_state(cfg) if f0 is None else np.asarray(f0, np.dtype(cfg.dtype))
        f = torch.tensor(f_init, dtype=dtype, device=self.device)
        # persistent kernel session: buffers and solid plane are built
        # once, and run() is then launches only
        self._session = None
        self._f = None
        if backend == "cuda":
            self._session = fused_kernel.Session(cfg, self.walls_np, device=self.device)
            self._session.load(f)
        else:
            self._f = f
        self.steps_done = 0
        self.elapsed = 0.0

    @property
    def f(self) -> torch.Tensor:
        """Current state on the device. On the cuda backend this is a copy
        of the session's live buffer, so it stays valid across run()."""
        return self._session.state() if self._session is not None else self._f

    @f.setter
    def f(self, value: torch.Tensor) -> None:
        if self._session is not None:
            self._session.load(value)
        else:
            self._f = value

    def run(self, n_steps: int, *, block: bool = True) -> "Simulation":
        """Advance n_steps on the device. With block (the default) the
        call returns after the device finished, so `elapsed` times the
        work and not its enqueueing."""
        t0 = time.perf_counter()
        if self._session is not None:
            self._session.advance(n_steps)
        else:
            self._f = self._run_steps(self._f, self.walls, self.cfg, n_steps)
        if block:
            _sync(self.device)
        self.elapsed += time.perf_counter() - t0
        self.steps_done += n_steps
        return self

    def probe_values(self, probes) -> np.ndarray:
        """(rho, u_x, u_y) at (P, 2) probe sites from the current state."""
        probes_np = np.asarray(probes)
        if probes_np.ndim != 2 or probes_np.shape[1] != 2:
            raise ValueError(f"probes must be (P, 2) (i, j) sites, got {probes_np.shape}")
        return to_numpy(torch_ops.probe_values(self.f, probes_np))

    def state(self) -> np.ndarray:
        """Current state as a host array in the storage dtype."""
        return to_numpy(self.f)

    def macroscopic(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        rho, ux, uy = torch_ops.macroscopic(self.f)
        return to_numpy(rho), to_numpy(ux), to_numpy(uy)

    def speed_squared(self) -> np.ndarray:
        """|u|^2 field, the quantity PrintLattice dumps
        (src/latticeboltzmann.c:631-633)."""
        _, ux, uy = self.macroscopic()
        return np.asarray(ux * ux + uy * uy)

    def reynolds(self, col: int | None = None) -> float:
        """Reynolds number at a column (default ny/2, the reference's
        regression scalar, src/latticeboltzmann.c:522-547)."""
        return float(torch_ops.reynolds(self.f, self.walls, self.cfg, col))

    @property
    def mlups(self) -> float:
        if self.elapsed == 0:
            return 0.0
        return self.cfg.sites * self.steps_done / self.elapsed / 1e6
