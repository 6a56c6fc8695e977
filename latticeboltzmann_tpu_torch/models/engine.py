"""Simulation facade: twin of latticeboltzmann_tpu/models/engine.py for
the port's backends.

- "torch": the portable engine (ops/stream_collide.py) on any device,
  the counterpart of "xla".
- "cuda": a persistent ops/fused_kernel.Session around the hand-written
  CUDA kernel, the counterpart of "pallas". It raises without a CUDA
  card, and on dtypes the kernel does not take yet; it never reroutes.
- "torch-ds64": the eager pair-DP engine (ops/ds_engine.py, the exact
  tier) on any device, the counterpart of "xla-ds64".
- "cuda-ds64": a persistent ops/fused_ds_kernel.Session around the CUDA
  ds kernel at the fast tier, the counterpart of "pallas-ds64". Like
  "cuda", it raises without a card.

The ds backends carry a df64.DS pair and need a float64 LatticeConfig
(the host-side precision of state() and f0); state(), macroscopic(),
reynolds() and probe_values() use the pair recombined to float64.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..core import geometry
from ..core.spec import NSPEEDS, W, LatticeConfig
from ..ops import df64, ds_engine, fused_ds_kernel, fused_kernel
from ..ops import stream_collide as torch_ops
from ..utils.interop import to_numpy, torch_dtype

# backend name -> run_steps(f, walls, cfg, n_steps) -> f
_BACKENDS: dict[str, Callable] = {}


def register_backend(name: str, run_steps: Callable) -> None:
    _BACKENDS[name] = run_steps


register_backend("torch", torch_ops.run_steps)
register_backend("cuda", fused_kernel.run_steps)
register_backend("torch-ds64", ds_engine.run_steps)
register_backend("cuda-ds64", fused_ds_kernel.run_steps)

# backends whose state is a df64.DS pair, and backends that run a
# hand-written kernel through a persistent session (CUDA only)
_DS_BACKENDS = {"torch-ds64", "cuda-ds64"}
_KERNEL_BACKENDS = {"cuda", "cuda-ds64"}


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


def default_device(backend: str) -> str:
    """The device a backend runs on when none is given: "cuda" for the
    kernel backends; for the others "cuda" when a card is available,
    else "cpu" (JAX's default device, the accelerator when there is
    one)."""
    if backend in _KERNEL_BACKENDS or torch.cuda.is_available():
        return "cuda"
    return "cpu"


class Simulation:
    """A running lattice. `backend` selects the compute path (see the
    module docstring); `device` defaults to default_device(backend)."""

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
        if backend in _DS_BACKENDS and np.dtype(cfg.dtype) != np.dtype(np.float64):
            raise ValueError(
                "ds backends carry DP-class state; construct the LatticeConfig "
                "with dtype=np.float64 (the host-side precision of state()/f0)"
            )
        self.device = torch.device(default_device(backend) if device is None else device)
        if backend in _KERNEL_BACKENDS and self.device.type != "cuda":
            raise ValueError(f"backend {backend!r} runs on a CUDA device, not {self.device}")
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
        if backend in _DS_BACKENDS:
            f = df64.from_f64(f_init, self.device)
        else:
            f = torch.tensor(f_init, dtype=dtype, device=self.device)
        # persistent kernel session: buffers and solid plane are built
        # once, and run() is then launches only
        self._session = None
        self._f = None
        if backend == "cuda":
            self._session = fused_kernel.Session(cfg, self.walls_np, device=self.device)
        elif backend == "cuda-ds64":
            self._session = fused_ds_kernel.Session(cfg, self.walls_np, device=self.device)
        if self._session is not None:
            self._session.load(f)
        else:
            self._f = f
        self.steps_done = 0
        self.elapsed = 0.0

    @property
    def f(self):
        """Current state on the device: a tensor, or a df64.DS pair on the
        ds backends. On the kernel backends this is a copy of the
        session's live buffers, so it stays valid across run()."""
        return self._session.state() if self._session is not None else self._f

    @f.setter
    def f(self, value) -> None:
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
        return to_numpy(torch_ops.probe_values(self._f64(), probes_np))

    def _f64(self) -> torch.Tensor:
        """The state on the device; on the ds backends the pair
        recombined to float64 (exact)."""
        f = self.f
        return ds_engine.recombine(f) if self.backend in _DS_BACKENDS else f

    def state(self) -> np.ndarray:
        """Current state as a host array: float64 on the ds backends (the
        pair recombined), the storage dtype otherwise."""
        if self.backend in _DS_BACKENDS:
            return ds_engine.state_f64(self.f)
        return to_numpy(self.f)

    def macroscopic(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        rho, ux, uy = torch_ops.macroscopic(self._f64())
        return to_numpy(rho), to_numpy(ux), to_numpy(uy)

    def speed_squared(self) -> np.ndarray:
        """|u|^2 field, the quantity PrintLattice dumps
        (src/latticeboltzmann.c:631-633)."""
        _, ux, uy = self.macroscopic()
        return np.asarray(ux * ux + uy * uy)

    def reynolds(self, col: int | None = None) -> float:
        """Reynolds number at a column (default ny/2, the reference's
        regression scalar, src/latticeboltzmann.c:522-547)."""
        return float(torch_ops.reynolds(self._f64(), self.walls, self.cfg, col))

    @property
    def mlups(self) -> float:
        if self.elapsed == 0:
            return 0.0
        return self.cfg.sites * self.steps_done / self.elapsed / 1e6
