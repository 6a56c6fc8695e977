"""Simulation facade: twin of latticeboltzmann_tpu/models/engine.py for
the port's backends.

- "torch": the portable engine (ops/stream_collide.py) on any device,
  the counterpart of "xla".
- "cuda": a persistent ops/fused_kernel.Session around the hand-written
  CUDA kernel, the counterpart of "pallas": float32 or bf16 storage, the
  mask computed in the kernel from geometry.infer_spec's closed form
  when there is one (as the JAX main path does), free-slip codes, fast
  math and, with temporal=T, passes of T steps per launch. It raises
  without a CUDA card, and on float64; it never reroutes.
- "torch-ds64": the eager pair-DP engine (ops/ds_engine.py, the exact
  tier) on any device, the counterpart of "xla-ds64".
- "cuda-ds64": a persistent ops/fused_ds_kernel.Session around the CUDA
  ds kernel at the fast tier, the counterpart of "pallas-ds64": like it,
  passes of DS_TEMPORAL = 4 pair steps per launch (the kernel's temporal
  form; one step a launch where NY is no multiple of 4). The facade's
  temporal= selects nothing here, as the JAX facade passes it only to
  "pallas". Like "cuda", it raises without a card.
- "sharded" / "sharded-sync": the eager row-sharded runner
  (parallel/sharded.py) with the overlap / sync schedule, on any device,
  the counterparts of the JAX backends of the same names.
- "sharded-cuda" / "sharded-cuda-fused": a persistent
  parallel/sharded.ShardedSession around the ext-halo form of the CUDA
  kernel, overlap (interior, then edge launches) / one launch per shard:
  the counterparts of "sharded-pallas" / "sharded-pallas-fused".
- "sharded-cuda-ds64": a persistent ShardedDSSession around the ext-halo
  form of the ds kernel at the fast tier, the counterpart of
  "sharded-pallas-ds64".
- "sharded-cuda-rdma": a persistent ShardedRdmaSession around the rdma
  form of the CUDA kernel, which exchanges its own halo rows: one launch
  per shard and step and no copy from the host, the counterpart of
  "sharded-pallas-rdma". Like that one it is experimental and needs
  allow_experimental=True: its shards wait for each other inside their
  kernels, so a ring that is not launched whole ends in a timeout error.
The sharded backends run over make_mesh(), every visible card; a caller
registers one over another mesh (devices may repeat) with
register_backend(name, sharded.make_backend(mesh, overlap=...)) or
sharded.make_cuda_backend(...), as in the JAX package. The kernel
backends raise without a card.

A backend function with a `session` attribute (session(cfg, walls, *,
device, **options) -> a session with load, advance, state) runs through
a persistent session that the facade keeps; any other runs as
run_steps(f, walls, cfg, n_steps, **options). A blocking run() ends with
the session's block(), or the backend function's own `block` attribute
where it has one (the eager sharded runners wait for every card of their
mesh), else with a synchronize of the simulation's device.

The ds backends carry a df64.DS pair and need a float64 LatticeConfig
(the host-side precision of state() and f0); state(), macroscopic(),
reynolds(), probe_values() and run_probed() use the pair recombined to
float64.

run_probed(n_steps, probes, every=) samples (rho, u_x, u_y) at probe
sites every `every` steps into a series on the device, one loop for every
backend (stream_collide.sample_every): `every` steps, then a gather. On
the session backends the gather reads the live buffers (the session's
probe_values), never a copy of the state; probe_values gathers so too.

Options, as the JAX facade's capability sets (engine.py:73-118 there):
slip_x/slip_y on _SLIP_BACKENDS, else NotImplementedError; fast_math on
_FASTMATH_BACKENDS, and ignored elsewhere, as the JAX _backend_kwargs
ignores it; the closed-form wall spec on _WALL_SPEC_BACKENDS.

bf16 storage (LatticeConfig(dtype="bfloat16"), or a JAX config's bf16
type): the host side never needs numpy bf16, so state(), macroscopic()
and f0 use float32 holding the exact bf16 values. That is the one place
where the port differs from the JAX facade, whose state() is
`np.asarray(self.f)` in bf16.
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
from ..parallel import sharded
from ..utils import viz
from ..utils.interop import round_bf16, state_tensor, storage_dtype, to_numpy

# backend name -> run_steps(f, walls, cfg, n_steps) -> f
_BACKENDS: dict[str, Callable] = {}


def register_backend(name: str, run_steps: Callable) -> None:
    _BACKENDS[name] = run_steps


def _with_session(run_steps: Callable, session: Callable) -> Callable:
    """run_steps as a backend whose facade keeps a persistent session."""

    def run(*args, **kwargs):
        return run_steps(*args, **kwargs)

    run.session = session
    return run


register_backend("torch", torch_ops.run_steps)
register_backend("cuda", _with_session(fused_kernel.run_steps, fused_kernel.Session))
register_backend("torch-ds64", ds_engine.run_steps)
register_backend("cuda-ds64", _with_session(fused_ds_kernel.run_steps, fused_ds_kernel.Session))
register_backend("sharded", sharded.make_backend(overlap=True))
register_backend("sharded-sync", sharded.make_backend(overlap=False))
register_backend("sharded-cuda", sharded.make_cuda_backend(overlap=True))
register_backend("sharded-cuda-fused", sharded.make_cuda_backend(overlap=False))
register_backend("sharded-cuda-ds64", sharded.make_cuda_ds_backend())
register_backend("sharded-cuda-rdma", sharded.make_cuda_backend(rdma=True))

# backends whose state is a df64.DS pair, and backends that run a
# hand-written kernel through a persistent session (CUDA only)
_DS_BACKENDS = {"torch-ds64", "cuda-ds64", "sharded-cuda-ds64"}
_KERNEL_BACKENDS = {"cuda", "cuda-ds64", "sharded-cuda", "sharded-cuda-fused",
                    "sharded-cuda-ds64", "sharded-cuda-rdma"}
# backends that take free-slip masks, the approximate 1/rho, and the
# closed-form wall spec (no mask plane read)
_SLIP_BACKENDS = {"torch", "cuda", "sharded", "sharded-sync", "sharded-cuda",
                  "sharded-cuda-fused", "sharded-cuda-rdma"}
_FASTMATH_BACKENDS = {"cuda", "sharded-cuda", "sharded-cuda-fused", "sharded-cuda-rdma"}
_WALL_SPEC_BACKENDS = {"cuda", "sharded-cuda", "sharded-cuda-fused", "sharded-cuda-rdma"}
# backends that run passes of `temporal` steps (the JAX facade's "pallas")
_TEMPORAL_BACKENDS = {"cuda"}
# backends that run only behind Simulation(allow_experimental=True)
_EXPERIMENTAL_BACKENDS = {"sharded-cuda-rdma"}


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


def initial_state(cfg: LatticeConfig) -> np.ndarray:
    """Rest-equilibrium initial fill (src/latticeboltzmann.c:583-591).

    bf16 storage returns float32 holding the exact bf16 values, rounded
    twice as the JAX package's numpy bf16 arithmetic rounds them:
    bf16(bf16(density) * bf16(W[s])) (the product of two bf16 values is
    exact in float32)."""
    st = storage_dtype(cfg.dtype)
    if st == torch.bfloat16:
        rho = round_bf16(np.float32(cfg.initial_density))
        w = round_bf16(W.astype(np.float32))
        fill = round_bf16(rho * w)
        return np.broadcast_to(fill[:, None, None], (NSPEEDS, cfg.nx, cfg.ny)).copy()
    dtype = np.float64 if st == torch.float64 else np.float32
    f = np.empty((NSPEEDS, cfg.nx, cfg.ny), dtype=dtype)
    rho = np.asarray(cfg.initial_density, dtype=dtype)
    for s in range(NSPEEDS):
        f[s] = rho * np.asarray(W[s], dtype=dtype)
    return f


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reynolds_sequential(f: np.ndarray, walls: np.ndarray, cfg: LatticeConfig) -> float:
    """Reynolds number over the central column from a host float64 state
    (src/latticeboltzmann.c:522-547): mean u_y of the non-wall sites at
    j = NY/2, times the characteristic length 10, over nu. The port's copy
    of the JAX package's golden.reynolds: numpy's elementwise float64
    arithmetic, then a strict sequential sum over i, like the C loop."""
    j = int(cfg.ny / 2.0)
    col = f[:, :, j]  # (9, NX)
    fluid = ~walls[:, j]
    density = col[0]
    for s in range(1, NSPEEDS):
        density = density + col[s]
    u_y = ((col[5] + col[1]) + col[8] - ((col[6] + col[3]) + col[7])) / density
    total = 0.0
    for v in u_y[fluid]:
        total += float(v)
    return total / int(fluid.sum()) * 10.0 / cfg.viscosity


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
    module docstring); `device` defaults to default_device(backend).

    skew and temporal are the JAX facade's schedule knobs (wavefront
    time-skewing and the temporal-blocking depth of the TPU kernels), kept
    as given. temporal=T on "cuda" runs passes of T steps through the
    temporal form of the kernel (fused_kernel.Session(temporal=T): n steps
    as n // T passes of T and one of the rest), bitwise equal to one step
    per launch; None (the default) and 1 keep one launch per step. On
    every other backend it selects nothing, as the JAX facade passes it
    only to "pallas" (models/engine.py:341-342 there). A temporal that is
    no integer or under 1 raises ValueError on every backend, as the JAX
    planner does (ops/fused_kernel.py:2008-2015 there); "cuda" also
    refuses a depth or shape the temporal form does not take
    (fused_kernel.Session). skew selects nothing anywhere: the
    JAX package's own tests hold its schedules bitwise equal to one another
    (tests/test_pallas.py:706-816), so one schedule gives every result it
    can select. allow_experimental opts in to the backends of
    _EXPERIMENTAL_BACKENDS, which raise RuntimeError without it."""

    def __init__(
        self,
        cfg: LatticeConfig,
        walls: np.ndarray | None = None,
        *,
        backend: str = "torch",
        device: str | torch.device | None = None,
        f0: np.ndarray | None = None,
        slip_x: np.ndarray | None = None,
        slip_y: np.ndarray | None = None,
        fast_math: bool = False,
        skew: bool | None = None,
        temporal: int | None = None,
        allow_experimental: bool = False,
    ):
        self.cfg = cfg
        self.skew = skew
        if temporal is not None and (isinstance(temporal, bool)
                                     or not isinstance(temporal, (int, np.integer))
                                     or temporal < 1):
            raise ValueError(f"temporal must be an integer >= 1 or None, got {temporal!r}")
        self.temporal = temporal
        storage_dtype(cfg.dtype)  # raises on what the port does not take
        if walls is None:
            walls = geometry.channel_with_barrier(cfg.nx, cfg.ny)
        if walls.shape != (cfg.nx, cfg.ny):
            raise ValueError(f"walls shape {walls.shape} != lattice {(cfg.nx, cfg.ny)}")
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; have {available_backends()}")
        if backend in _EXPERIMENTAL_BACKENDS and not allow_experimental:
            raise RuntimeError(
                f"{backend} is EXPERIMENTAL: its shards exchange halo rows inside their "
                "kernels and wait for each other there. Pass allow_experimental=True to "
                "Simulation to opt in; prefer 'sharded-cuda' otherwise."
            )
        if backend in _DS_BACKENDS and storage_dtype(cfg.dtype) != torch.float64:
            raise ValueError(
                "ds backends carry DP-class state; construct the LatticeConfig "
                "with dtype=np.float64 (the host-side precision of state()/f0)"
            )
        has_slip = slip_x is not None or slip_y is not None
        if has_slip and backend not in _SLIP_BACKENDS:
            raise NotImplementedError(
                f"free-slip boundaries are not implemented on the {backend!r} "
                f"backend; supported: {sorted(_SLIP_BACKENDS)}"
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
        # kept as given; outside _FASTMATH_BACKENDS it is ignored, as the
        # JAX facade's _backend_kwargs ignores it
        self.fast_math = fast_math
        self.walls_np = np.asarray(walls, dtype=bool)
        self.walls = torch.as_tensor(self.walls_np, device=self.device)
        # closed-form geometry spec (None for arbitrary masks): the kernel
        # computes the mask instead of reading a plane. Slip masks are
        # arbitrary, so slip runs read the class plane.
        self.wall_spec = (
            geometry.infer_spec(self.walls_np)
            if backend in _WALL_SPEC_BACKENDS and not has_slip
            else None
        )
        self.slip_x = None if slip_x is None else np.asarray(slip_x, dtype=bool)
        self.slip_y = None if slip_y is None else np.asarray(slip_y, dtype=bool)
        f_init = initial_state(cfg) if f0 is None else f0
        if backend in _DS_BACKENDS:
            f = df64.from_f64(np.asarray(f_init, np.float64), self.device)
        else:
            f = state_tensor(f_init, cfg.dtype, self.device)
        # the options a backend takes, by the capability sets
        options = {}
        if has_slip:
            options.update(slip_x=self.slip_x, slip_y=self.slip_y)
        if backend in _WALL_SPEC_BACKENDS:
            options["wall_spec"] = self.wall_spec
        if backend in _FASTMATH_BACKENDS:
            options["fast_math"] = fast_math
        if backend in _TEMPORAL_BACKENDS and temporal is not None:
            options["temporal"] = int(temporal)
        # persistent kernel session: buffers and geometry are built
        # once, and run() is then launches only
        self._session = None
        self._f = None
        self._options = {}
        session = getattr(self._run_steps, "session", None)
        if session is not None:
            self._session = session(cfg, self.walls_np, device=self.device, **options)
        else:
            self._options = {
                name: torch.as_tensor(m, device=self.device) if name.startswith("slip") else m
                for name, m in options.items() if m is not None
            }
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
        self._advance(n_steps)
        if block:
            self._block()
        self.elapsed += time.perf_counter() - t0
        self.steps_done += n_steps
        return self

    def _advance(self, n_steps: int) -> None:
        if self._session is not None:
            self._session.advance(n_steps)
        else:
            self._f = self._run_steps(self._f, self.walls, self.cfg, n_steps, **self._options)

    def _block(self) -> None:
        """Wait for the work run() enqueued: the session's own barrier,
        else the backend function's, else this simulation's device."""
        if self._session is not None:
            self._session.block()
            return
        block = getattr(self._run_steps, "block", None)
        if block is not None:
            block()
        else:
            _sync(self.device)

    def run_probed(self, n_steps: int, probes, *, every: int = 1,
                   block: bool = True) -> np.ndarray:
        """Advance n_steps while recording (rho, u_x, u_y) at the (P, 2)
        probe sites (i, j) every `every` steps; returns the series as a
        numpy (n_steps // every, P, 3) array (float64 on the ds backends
        and for float64 storage, float32 otherwise). On every backend:
        `every` steps, then a gather (_probe) into a series preallocated
        on the device and fetched once at the end; `elapsed` and
        `steps_done` advance as in run().

        Raises ValueError, before any step, unless `every` divides
        n_steps and the probes are (P, 2) sites inside the lattice."""
        sites = self._probe_sites(probes)
        dtype = (torch.float64 if self.backend in _DS_BACKENDS
                 else torch_ops.moment_dtype(storage_dtype(self.cfg.dtype)))
        t0 = time.perf_counter()
        series = torch_ops.sample_every(n_steps, every, len(sites), dtype, self.device,
                                        self._advance, lambda: self._probe(sites))
        if block:
            self._block()
        self.elapsed += time.perf_counter() - t0
        self.steps_done += n_steps
        return to_numpy(series)

    def probe_values(self, probes) -> np.ndarray:
        """(rho, u_x, u_y) at (P, 2) probe sites from the current state;
        on the session backends gathered from the live buffers, with no
        copy of the state. Raises ValueError as run_probed."""
        values = self._probe(self._probe_sites(probes))
        self._block()  # a session's own checks, as state() makes them
        return to_numpy(values)

    def _probe_sites(self, probes):
        if self._session is not None:
            return self._session.probe_sites(probes)
        return torch_ops.probe_sites(probes, self.cfg, self.device)

    def _probe(self, sites) -> torch.Tensor:
        """The moments at _probe_sites' sites: from the session's live
        buffers, else from the state; on the ds backends from the pair
        recombined in float64."""
        if self._session is not None:
            return self._session.probe_values(sites)
        if self.backend in _DS_BACKENDS:
            return ds_engine.probe_values(self._f, sites)
        return torch_ops.probe_values(self._f, sites)

    def _f64(self) -> torch.Tensor:
        """The state on the device; on the ds backends the pair
        recombined to float64 (exact)."""
        f = self.f
        return ds_engine.recombine(f) if self.backend in _DS_BACKENDS else f

    def state(self) -> np.ndarray:
        """Current state as a host array: float64 on the ds backends (the
        pair recombined), float32 for bf16 storage (the exact upcast:
        numpy has no bf16 without ml_dtypes), the storage dtype
        otherwise."""
        if self.backend in _DS_BACKENDS:
            return ds_engine.state_f64(self.f)
        return to_numpy(self.f)

    def macroscopic(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        rho, ux, uy = torch_ops.macroscopic(self._f64())
        return to_numpy(rho), to_numpy(ux), to_numpy(uy)

    def speed_squared(self) -> np.ndarray:
        """|u|^2 field, the quantity PrintLattice dumps
        (src/latticeboltzmann.c:631-633)."""
        return to_numpy(viz.speed_squared(self._f64()))

    def reynolds(self, col: int | None = None) -> float:
        """Reynolds number at a column (default ny/2, the reference's
        regression scalar, src/latticeboltzmann.c:522-547). On the ds
        backends the default column is summed on the host, one site after
        the other in float64, as the JAX facade does through its golden
        model (models/engine.py:511-516, models/golden.py:204-220 there):
        a device sum adds in another order."""
        if self.backend in _DS_BACKENDS and col is None:
            return _reynolds_sequential(self.state(), self.walls_np, self.cfg)
        return float(torch_ops.reynolds(self._f64(), self.walls, self.cfg, col))

    @property
    def mlups(self) -> float:
        if self.elapsed == 0:
            return 0.0
        return self.cfg.sites * self.steps_done / self.elapsed / 1e6
