"""Row-sharded lattice over an in-process device mesh: twin of
latticeboltzmann_tpu/parallel/sharded.py, the reference's MPI row
decomposition (README.md:44-57).

The JAX package runs one controlling process: shard_map over a 1-D mesh
of devices, halo rows swapped by ppermute. The counterpart here is one
process too. A Mesh is a tuple of torch.devices, one shard per entry; a
device may repeat ("virtual shards", as the JAX tests' 8 virtual CPU
devices), so one card, or the CPU, runs every line of the path. Shard k
holds global rows [k L, (k + 1) L) of the (9, NX, NY) state, L = NX / n,
and the ring neighbours' boundary rows move by device-to-device copies
(Tensor.copy_, peer to peer between cards).

Three runners, each with the JAX package's overlap and sync schedules:
- make_run_steps / make_backend ("sharded", "sharded-sync"): the eager
  step of sharded.py:77-202 there on the port's plain ops, any device.
  The forcing runs before the exchange, so 3 speed planes of a boundary
  row suffice (UP_SPEEDS, DOWN_SPEEDS).
- ShardedSession, make_cuda_run_steps / make_cuda_backend
  ("sharded-cuda", "sharded-cuda-fused"): the twin of
  make_pallas_run_steps (:212-615 there), in passes of T =
  SHARDED_TEMPORAL steps (3 in float32, 2 in bf16, the JAX runner's
  depth, :264-286 there): each shard's T-row halos (all 9 planes: the
  kernel forces a halo row's column-0 site itself) exchanged once per
  pass, every pass through the ext-halo temporal form of the
  stream-collide kernel (ops/fused_kernel.ext_temporal_launcher), n steps
  as n // T passes and one of the rest. The one-step ext-halo form
  (fused_kernel.ext_launcher, one-row halos, an exchange per step) runs
  instead at temporal=1, where NY is no whole number of 16-byte vectors
  and where a shard has fewer than T rows.
- ShardedDSSession, make_cuda_ds_run_steps / make_cuda_ds_backend
  ("sharded-cuda-ds64"): the twin of fused_ds_kernel._get_sharded_runner
  and sharded_run_steps (:385-500 there): passes of DS_TEMPORAL = 4 pair
  steps per shard through the ext-halo temporal form of the pair-DP
  kernel (fused_ds_kernel.ext_temporal_launcher), the T-row pair halos of
  each shard exchanged once per pass, n steps as n // T passes and one of
  the rest; the one-step ext-halo form (fused_ds_kernel.ext_launcher)
  where the temporal form does not apply (temporal=1, the exact tier, NY
  no multiple of 4, shards of fewer than T rows).

- ShardedRdmaSession, make_cuda_run_steps(rdma=True) /
  make_cuda_backend(rdma=True) ("sharded-cuda-rdma"): the twin of
  make_pallas_run_steps(rdma=True) (:221, :351-352 there). One launch per
  shard and pass of the rdma temporal form of the stream-collide kernel
  (ops/fused_kernel.rdma_temporal_launcher) sends its own T edge rows
  into the neighbours' comm blocks and runs the pass; the host makes no
  copy and no event in the pass loop. The one-step rdma form
  (fused_kernel.rdma_launcher) runs where the passes do not apply
  (temporal=1, NY of no whole 16-byte vectors, a shard of fewer than 2 T
  + 1 rows: no interior to hide the exchange behind), and a shard of
  fewer than 3 rows keeps the exchange-then-launch. Each shard launches
  on a stream of its own, virtual shards of one card too: a shard's edge
  tiles wait inside its kernel for the neighbours' kernels of the same
  pass, which must not queue behind it.

Each of these choices of form is made by shape and counted per form,
never a reaction to a failed build or launch. The TPU runner's `br < 32`
clause (T = 2 for VMEM-capped row blocks) is the TPU's block and is not
ported.

overlap=True starts the halo copies, launches the interior rows [s,
L-s) of a pass of s steps, which take no halo, then waits for the copies
and launches the two s-row bands: _trio (:312-376 there) at row
granularity (at one step a pass, rows [1, L-1) and rows 0 and L-1). A
shard of fewer than 2 s + 1 rows takes one launch. overlap=False
exchanges, then launches each shard once. Both are bitwise equal to the
single-chip paths.

Every runner moves its halo rows through HaloExchange. On a mesh of one
card every copy and launch runs on the current stream, in order. Across
cards each card has a copy stream: the
copies wait on an event recorded on each card's current stream (the
rows they read are written, the halo rows they overwrite are read), and
each card's edge launches wait on every card's copy event, so no copy
reads a row that a pending launch still writes. The step loop makes no
host sync. The kernel sessions refuse a mesh of another device type than
the state's. Their probe gather (probe_values) takes each
probe on the shard that owns its row and copies the moments to the
session's device; no shard's state is joined for it. shards() hands
out the live shards and load() takes a sequence of them, one shard at a
time (the shard-by-shard checkpoint). HaloExchange.start opens the span
HALO_SPAN (utils/profiler.span), so scripts/scaling.py reads the
exchange's share of the card's time from it. A multi-process
transport (torch.distributed) is ROADMAP work; the union-mask launch
partition of the JAX path is TPU launch economy (ROADMAP, "Not to
port").
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.spec import E, NSPEEDS, REFLECT_X, REFLECT_Y, LatticeConfig
from ..ops import ds_engine, fused_ds_kernel, fused_kernel
from ..ops import stream_collide as ops
from ..ops.df64 import DS
from ..ops.fused_kernel import ShardPlane
from ..utils import profiler
from ..utils.interop import compute_dtype

# speeds that pull from the row above (e_x = +1) / below (e_x = -1)
UP_SPEEDS = (2, 5, 6)
DOWN_SPEEDS = (4, 7, 8)

# row copies started by HaloExchange.start, for callers that must show a
# path started none (the rdma form exchanges inside its kernel)
HALO_COPIES = 0

# the span HaloExchange.start opens in a torch.profiler trace around the
# copies it issues (only while a profiler runs: a span costs host time
# on every call); scripts/scaling.py's trace reader takes the card's
# copies launched inside it as the halo exchange
HALO_SPAN = "lbm_halo_exchange"

# the steps of a pass of the f32/bf16 kernel sessions by storage type: the
# JAX runner's depth (make_pallas_run_steps, sharded.py:264-286 there)
SHARDED_TEMPORAL = {torch.float32: 3, torch.bfloat16: 2}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the lattice's x axis: one shard per device entry,
    in row order. Entries may repeat a device."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def unique_devices(self) -> list[torch.device]:
        """The distinct devices, in mesh order."""
        return list(dict.fromkeys(self.devices))


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh over `devices` (names or torch.devices; repeats allowed),
    by default every visible CUDA device (the CPU when there is none),
    cut to the first n_devices. A CUDA device without an index is the
    current one."""
    if devices is None:
        if torch.cuda.is_available():
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device("cpu")]
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(f"{n_devices} devices asked for, {len(devices)} visible")
            devices = devices[:n_devices]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in out}) != 1:
        raise ValueError(f"a mesh holds devices of one type, got {out}")
    return Mesh(tuple(out))


def shard_rows(nx: int, n_shards: int) -> int:
    """Rows per shard; raises unless NX divides evenly (sharded.py:261-262
    there)."""
    if nx % n_shards:
        raise ValueError(f"NX={nx} not divisible by {n_shards} devices")
    return nx // n_shards


def _blocks(mesh: Mesh, x: torch.Tensor, dim: int) -> list[torch.Tensor]:
    """x split on `dim` into contiguous row blocks, block k on mesh
    device k."""
    L = shard_rows(x.shape[dim], mesh.size)
    return [x.narrow(dim, k * L, L).to(d, copy=True).contiguous()
            for k, d in enumerate(mesh.devices)]


def shard_state(mesh: Mesh, f: torch.Tensor, walls: torch.Tensor | None = None):
    """Split a (9, NX, NY) state, and an (NX, NY) mask if given, on rows
    over the mesh: lists of contiguous blocks, block k on mesh device k.
    Returns the state's list, or (state's, mask's)."""
    fs = _blocks(mesh, f, 1)
    return fs if walls is None else (fs, _blocks(mesh, walls, 0))


def gather_state(shards: list[torch.Tensor], device=None) -> torch.Tensor:
    """Join row blocks back into one (9, NX, NY) state on `device`
    (default: the first block's)."""
    device = shards[0].device if device is None else torch.device(device)
    return torch.cat([s.to(device) for s in shards], dim=1)


class HaloExchange:
    """Copies of halo rows between the shards of a mesh, for every runner
    here: start(copies) issues (dst, src) row copies, finish() makes the
    current streams wait for them. On one device (or the CPU) the copies run on the current
    stream and finish() does nothing. Across cards the copies run on one
    copy stream per card, each after an event recorded on its card's
    current stream, and finish() makes every card's current stream wait
    on every card's copy event."""

    def __init__(self, mesh: Mesh):
        self.devices = mesh.unique_devices()
        self.multi = self.devices[0].type == "cuda" and len(self.devices) > 1
        if self.multi:
            self.streams = [torch.cuda.Stream(d) for d in self.devices]
            self.ready = [torch.cuda.Event() for _ in self.devices]
            self.done = [torch.cuda.Event() for _ in self.devices]

    def start(self, copies) -> None:
        global HALO_COPIES
        HALO_COPIES += len(copies)
        with profiler.span(HALO_SPAN):
            self._start(copies)

    def _start(self, copies) -> None:
        if not self.multi:
            for dst, src in copies:
                dst.copy_(src)
            return
        for d, ev in zip(self.devices, self.ready):
            ev.record(torch.cuda.current_stream(d))
        with contextlib.ExitStack() as stack:
            # a copy between cards orders itself against the current
            # streams of both: make those the copy streams
            for s, ev in zip(self.streams, self.ready):
                stack.enter_context(torch.cuda.stream(s))
                s.wait_event(ev)
            for dst, src in copies:
                dst.copy_(src, non_blocking=True)
            for s, ev in zip(self.streams, self.done):
                ev.record(s)

    def finish(self) -> None:
        if self.multi:
            for d in self.devices:
                stream = torch.cuda.current_stream(d)
                for ev in self.done:
                    stream.wait_event(ev)


def exchange_halos(shards: list[torch.Tensor], exchange: HaloExchange | None = None,
                   up=UP_SPEEDS, down=DOWN_SPEEDS):
    """Each shard's (top, bot) halo rows, copied onto its device from its
    ring neighbours through `exchange` (default: a HaloExchange over the
    shards' devices): top = the `up` speed planes of the upper neighbour's
    last row (global row r0 - 1), bot = the `down` planes of the lower
    neighbour's first row (global row r0 + L); each (len(speeds), 1, NY).
    The eager runner's exchange (sharded.py:58-74 there)."""
    if exchange is None:
        exchange = HaloExchange(Mesh(tuple(f.device for f in shards)))
    n, ny = len(shards), shards[0].shape[-1]
    out = [(f.new_empty(len(up), 1, ny), f.new_empty(len(down), 1, ny)) for f in shards]
    copies = []
    for k, (top, bot) in enumerate(out):
        above, below = shards[(k - 1) % n], shards[(k + 1) % n]
        copies += [(top[i], above[s, -1:]) for i, s in enumerate(up)]
        copies += [(bot[i], below[s, :1]) for i, s in enumerate(down)]
    exchange.start(copies)
    exchange.finish()
    return out


# --- the eager runner ("sharded", "sharded-sync") ---------------------------


def _pull_padded(f_local: torch.Tensor, top: torch.Tensor, bot: torch.Tensor) -> torch.Tensor:
    """Pull gather on a local block given its halo rows: y wraps locally
    (y is unsharded); x takes the halo rows instead of a wrap."""
    pulled = []
    for s in range(NSPEEDS):
        ex, ey = int(E[s, 0]), int(E[s, 1])
        plane = torch.roll(f_local[s], ey, dims=1) if ey else f_local[s]
        if ex == 0:
            pulled.append(plane)
            continue
        halo = top[UP_SPEEDS.index(s)] if ex == 1 else bot[DOWN_SPEEDS.index(s)]
        halo = torch.roll(halo, ey, dims=1) if ey else halo
        pieces = [halo, plane[:-1]] if ex == 1 else [plane[1:], halo]
        pulled.append(torch.cat(pieces, dim=0))
    return torch.stack(pulled)


def _finish(pulled: torch.Tensor, walls_l, cfg: LatticeConfig, slip_x_l=None,
            slip_y_l=None) -> torch.Tensor:
    """Collide and the solid classes on pulled distributions, precedence
    walls > slip_x > slip_y, as ops.stream_collide: with bf16 storage the
    arithmetic runs in float32 and rounds once on return."""
    storage = pulled.dtype
    pulled = pulled.to(compute_dtype(cfg.dtype))
    relaxed = ops.collide(pulled, cfg)
    if slip_y_l is not None:
        relaxed = torch.where(slip_y_l[None], pulled[list(REFLECT_Y)], relaxed)
    if slip_x_l is not None:
        relaxed = torch.where(slip_x_l[None], pulled[list(REFLECT_X)], relaxed)
    return torch.where(walls_l[None], pulled[list(ops.OPPOSITE)], relaxed).to(storage)


def _step(shards, walls, cfg: LatticeConfig, overlap: bool, exchange: HaloExchange,
          slip_x=None, slip_y=None):
    """One step of every shard: forcing, halo exchange, stream and
    collide. With overlap the interior rows [1, L-1) are computed from the
    local block alone before the edge rows take the halos
    (sharded.py:116-152 there)."""
    n = len(shards)
    solid = list(walls)
    for masks in (slip_x, slip_y):
        if masks is not None:
            solid = [s | m for s, m in zip(solid, masks)]
    forced = [ops.apply_source(f, s, cfg) for f, s in zip(shards, solid)]
    halos = exchange_halos(forced, exchange)

    def finish(k, pulled, rows):
        return _finish(pulled, walls[k][rows], cfg,
                       None if slip_x is None else slip_x[k][rows],
                       None if slip_y is None else slip_y[k][rows])

    everything = slice(None)
    if not overlap or shards[0].shape[1] < 3:
        return [finish(k, _pull_padded(forced[k], *halos[k]), everything) for k in range(n)]
    # the local pull wraps x inside the block; rows 1..L-2 never read a
    # wrapped row, so its interior equals the true pull
    interior = [finish(k, ops.pull(forced[k])[:, 1:-1], slice(1, -1)) for k in range(n)]
    out = []
    for k in range(n):
        pulled = _pull_padded(forced[k], *halos[k])
        top = finish(k, pulled[:, :1], slice(None, 1))
        bot = finish(k, pulled[:, -1:], slice(-1, None))
        out.append(torch.cat([top, interior[k], bot], dim=1))
    return out


def make_run_steps(mesh: Mesh, cfg: LatticeConfig, *, overlap: bool = True):
    """(f, walls, n_steps, slip_x=None, slip_y=None) -> f over the mesh:
    the global state and masks are split on rows, stepped shard by shard
    and joined again on f's device. Raises unless NX divides evenly."""
    shard_rows(cfg.nx, mesh.size)

    def run_steps(f, walls, n_steps: int, slip_x=None, slip_y=None):
        fs, ws = shard_state(mesh, f, torch.as_tensor(walls))
        sx = None if slip_x is None else _blocks(mesh, torch.as_tensor(slip_x), 0)
        sy = None if slip_y is None else _blocks(mesh, torch.as_tensor(slip_y), 0)
        exchange = HaloExchange(mesh)
        for _ in range(n_steps):
            fs = _step(fs, ws, cfg, overlap, exchange, sx, sy)
        return gather_state(fs, f.device)

    return run_steps


def _synchronize(mesh: Mesh) -> None:
    """Wait for every card of the mesh (all its streams)."""
    for d in mesh.unique_devices():
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def make_backend(mesh: Mesh | None = None, *, overlap: bool = True):
    """The eager runner as a Simulation backend, run(f, walls, cfg,
    n_steps, slip_x=None, slip_y=None), over `mesh` (default: make_mesh()
    at the call); run.block() waits for every card of the mesh."""

    def run(f, walls, cfg, n_steps, slip_x=None, slip_y=None):
        m = make_mesh() if mesh is None else mesh
        return make_run_steps(m, cfg, overlap=overlap)(f, walls, n_steps, slip_x, slip_y)

    def block():
        _synchronize(make_mesh() if mesh is None else mesh)

    run.block = block
    return run


# --- the kernel runners ("sharded-cuda", "-fused", "-ds64") -----------------


def _on(device: torch.device):
    """A context that makes `device` current (kernels launch on the
    current device's stream)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class ShardSites:
    """Probe sites of a sharded session (its probe_sites): P, and per shard
    that owns any, (shard, device, their rows in the series on the
    session's device, their local (i, j) on the shard's device)."""

    count: int
    groups: list

    def __len__(self) -> int:
        return self.count


class _ShardedKernelSession:
    """What the kernel sessions share: per shard two buffers of each state
    component (the state's tensor, or a pair's hi and lo) that swap roles
    every pass, the halo blocks of each component above and below the
    shard ((9, NY) rows, or (9, T, NY) blocks for passes of T = temporal
    steps), the halo exchange and the launch plan of each buffer parity
    and pass depth. Subclasses give the components and the launches."""

    temporal = 1

    def __init__(self, cfg: LatticeConfig, mesh: Mesh, n_comp: int, dtype: torch.dtype,
                 overlap: bool, device):
        self.cfg = cfg
        self.mesh = mesh
        self.overlap = overlap
        self.L = shard_rows(cfg.nx, mesh.size)
        self.device = torch.device(mesh.devices[0] if device is None else device)
        if any(d.type != self.device.type for d in mesh.devices):
            # the kernel runs where the shards lie: a CPU mesh behind a
            # card's state would run the plain version on the CPU
            raise ValueError(f"the mesh's devices {list(mesh.devices)} are not of the "
                             f"state's device type {self.device.type!r}")
        self.exchange = HaloExchange(mesh)
        shape = (NSPEEDS, self.L, cfg.ny)
        self._bufs = [[[torch.empty(shape, dtype=dtype, device=d) for d in mesh.devices]
                       for _ in range(n_comp)] for _ in range(2)]
        halo = (NSPEEDS, cfg.ny) if self.temporal == 1 else (NSPEEDS, self.temporal, cfg.ny)
        self._top = [[torch.empty(halo, dtype=dtype, device=d) for d in mesh.devices]
                     for _ in range(n_comp)]
        self._bot = [[torch.empty_like(t) for t in comp] for comp in self._top]
        self._parity = 0
        # the plans of full passes by parity, and of shorter ones by
        # (parity, steps)
        self._plans = None
        self._short_plans = {}

    def _edge_rows(self, x: torch.Tensor, dim: int, side: str) -> torch.Tensor:
        """The rows of x along `dim` that a neighbour's halo holds: the last
        (side "last") or first `temporal` rows, without that axis for
        passes of one step."""
        t, n = self.temporal, x.shape[dim]
        if t == 1:
            return x.select(dim, n - 1 if side == "last" else 0)
        return x.narrow(dim, n - t if side == "last" else 0, t)

    def _shard_geometry(self, plane: np.ndarray) -> list[ShardPlane]:
        """A host (NX, NY) uint8 class plane split over the mesh, with
        each shard's static halo class rows ((NY,), or (T, NY) for passes
        of T steps): one exchange per session."""
        n = self.mesh.size
        planes = _blocks(self.mesh, torch.as_tensor(plane), 0)
        tops = [torch.empty_like(self._edge_rows(p, 0, "last")) for p in planes]
        bots = [torch.empty_like(t) for t in tops]
        self.exchange.start([c for k in range(n) for c in (
            (tops[k], self._edge_rows(planes[(k - 1) % n], 0, "last")),
            (bots[k], self._edge_rows(planes[(k + 1) % n], 0, "first")))])
        self.exchange.finish()
        return [ShardPlane(p, t, b) for p, t, b in zip(planes, tops, bots)]

    def _launcher(self, k: int, src, dst, halo, row0: int, rows: int,
                  steps: int) -> Callable[[], None]:
        raise NotImplementedError

    def _pack(self, comps):
        raise NotImplementedError

    def _plan(self, parity: int, steps: int):
        """(copies, interior launches, edge launches) for a pass of `steps`
        steps that reads buffer `parity` and writes the other, launches
        grouped by device: the interior rows [steps, L - steps) read no
        halo."""
        src_bufs, dst_bufs = self._bufs[parity], self._bufs[1 - parity]
        n, L = self.mesh.size, self.L
        copies = []
        for c, comp in enumerate(src_bufs):
            for k in range(n):
                copies.append((self._top[c][k], self._edge_rows(comp[(k - 1) % n], 1, "last")))
                copies.append((self._bot[c][k], self._edge_rows(comp[(k + 1) % n], 1, "first")))
        interior, edges = {}, {}
        for k, dev in enumerate(self.mesh.devices):
            src = self._pack([comp[k] for comp in src_bufs])
            dst = self._pack([comp[k] for comp in dst_bufs])
            halo = (self._pack([t[k] for t in self._top]), self._pack([b[k] for b in self._bot]))
            with _on(dev):
                if self.overlap and L >= 2 * steps + 1:
                    interior.setdefault(dev, []).append(
                        self._launcher(k, src, dst, None, steps, L - 2 * steps, steps))
                    edges.setdefault(dev, []).extend(
                        self._launcher(k, src, dst, halo, r, steps, steps)
                        for r in (0, L - steps))
                else:
                    edges.setdefault(dev, []).append(
                        self._launcher(k, src, dst, halo, 0, L, steps))
        return copies, list(interior.items()), list(edges.items())

    def load(self, f) -> None:
        """Copy a state into the shards' current buffers: a global state
        (a tensor, or a DS pair), or a sequence of mesh.size shards in row
        order ((9, L, NY) tensors or DS pairs, on any device: shards(), or
        utils/checkpoint.load_shards), taken one at a time, so no
        whole-state tensor is made; a shard of another shape or dtype than
        the session's buffers raises. The plans of full passes are built at
        the first load, a shorter pass's at its first run."""
        if torch.is_tensor(f) or isinstance(f, DS):
            comps = [f] if torch.is_tensor(f) else [f.hi, f.lo]
            for c, x in enumerate(comps):
                for dst, block in zip(self._bufs[self._parity][c], shard_state(self.mesh, x)):
                    dst.copy_(block)
        else:
            self._load_shards(f)
        if self._plans is None:
            self._plans = [self._plan(p, self.temporal) for p in (0, 1)]

    def _load_shards(self, shards) -> None:
        """load() of a sequence of shards: shard k is read (a checkpoint's
        reads its rows here), copied into buffer k and let go before the
        next is read."""
        n, bufs = self.mesh.size, self._bufs[self._parity]
        if len(shards) != n:
            raise ValueError(f"{len(shards)} shards for a mesh of {n}")
        shape = (NSPEEDS, self.L, self.cfg.ny)
        for k in range(n):
            block = shards[k]
            comps = [block] if torch.is_tensor(block) else [block.hi, block.lo]
            if len(comps) != len(bufs) or any(tuple(x.shape) != shape for x in comps):
                raise ValueError(f"shard {k}: {len(comps)} component(s) of shape "
                                 f"{[tuple(x.shape) for x in comps]}; the session holds "
                                 f"{len(bufs)} of {shape}")
            # copy_ would round another storage dtype without a word
            if any(x.dtype != dst[k].dtype for x, dst in zip(comps, bufs)):
                raise ValueError(f"shard {k}: {[x.dtype for x in comps]}; the session holds "
                                 f"{[dst[k].dtype for dst in bufs]}")
            for c, dst in enumerate(bufs):
                dst[k].copy_(comps[c])
            del block, comps  # no name holds the shard while the next is read

    def _passes(self, n_steps: int) -> list[int]:
        """The steps of each pass of n_steps: n // T passes of T =
        temporal and one of the rest (sharded_run_steps' divmod there)."""
        full, rest = divmod(n_steps, self.temporal)
        return [self.temporal] * full + ([rest] if rest else [])

    def _plan_for(self, steps: int):
        """The plan of a pass of `steps` steps from the current buffer
        parity: a full pass's, or a shorter one's, built at its first
        run."""
        if steps == self.temporal:
            return self._plans[self._parity]
        key = (self._parity, steps)
        if key not in self._short_plans:
            self._short_plans[key] = self._plan(*key)
        return self._short_plans[key]

    def advance(self, n_steps: int) -> None:
        """n_steps in passes (_passes): per pass the halo copies, the
        interior launches, the wait for the copies, the edge launches; no
        host sync."""
        for steps in self._passes(n_steps):
            copies, interior, edges = self._plan_for(steps)
            self.exchange.start(copies)
            for dev, calls in interior:
                with _on(dev):
                    for call in calls:
                        call()
            self.exchange.finish()
            for dev, calls in edges:
                with _on(dev):
                    for call in calls:
                        call()
            self._parity ^= 1

    def block(self) -> None:
        """Completion barrier for the launches so far."""
        _synchronize(self.mesh)

    def state(self):
        """The current global state on the session's device, joined from
        the shards (a copy; the session keeps running)."""
        comps = [gather_state(comp, self.device) for comp in self._bufs[self._parity]]
        return self._pack(comps)

    def shards(self) -> list:
        """The live shards of the current state, one per mesh entry in row
        order: (9, L, NY) tensors, or DS pairs, each on its device; not
        joined and not copied (state() is the join). They are the
        session's own buffers, so they hold this state until the next
        advance(): read them before it (utils/checkpoint.save(...,
        format="sharded") does, one shard at a time)."""
        return [self._pack([comp[k] for comp in self._bufs[self._parity]])
                for k in range(self.mesh.size)]

    def probe_sites(self, probes) -> ShardSites:
        """(P, 2) global probe sites (i, j) grouped by the shard that owns
        row i (shard i // L, local row i mod L); raises as
        stream_collide.probe_sites."""
        sites = ops.probe_sites(probes, self.cfg, "cpu")
        groups = []
        for k, dev in enumerate(self.mesh.devices):
            mine = torch.nonzero(sites[:, 0] // self.L == k).flatten()
            if len(mine):
                local = sites[mine] - torch.tensor([k * self.L, 0])
                groups.append((k, dev, mine.to(self.device), local.to(dev)))
        return ShardSites(sites.shape[0], groups)

    def _moments(self, shard, sites: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def probe_values(self, sites: ShardSites) -> torch.Tensor:
        """(rho, u_x, u_y) at probe_sites' sites of the live shards: (P, 3)
        on the session's device. Each shard gathers its own probes from
        its current buffer and copies them over; no shard's state is
        joined."""
        out = torch.empty((sites.count, 3), dtype=self.moment_dtype, device=self.device)
        for k, dev, rows, local in sites.groups:
            with _on(dev):
                vals = self._moments(self._pack([comp[k] for comp in self._bufs[self._parity]]),
                                     local)
            out[rows] = vals.to(self.device)
        return out

    def unload(self):
        """The current global state; the session releases its buffers."""
        out = self.state()
        self._bufs = self._top = self._bot = self._plans = None
        self._short_plans = {}
        return out


class ShardedSession(_ShardedKernelSession):
    """Persistent sharded state of the stream-collide kernel's shard forms
    over a mesh, the twin of fused_kernel.Session for the row-sharded path:
    float32 or bf16 storage, the geometry of host_geometry (none, the wall
    spec evaluated at global rows, or the class plane with its static halo
    class rows), fast math. overlap selects the schedule. state() and
    load() take the global (9, NX, NY) state on `device` (default: the
    first mesh device); shards() gives the live shards, one per mesh
    entry, and load() also takes such a sequence, so a state moves shard
    by shard (utils/checkpoint.py's "sharded" format).

    temporal (default None: SHARDED_TEMPORAL by storage, the JAX runner's
    depth): n steps run as n // T passes of T steps and one of n % T
    through the ext-halo temporal form (fused_kernel.ext_temporal_launcher),
    each shard's T-row halos and static (T, NY) class rows beside them, the
    halos exchanged once per pass. The one-step ext-halo form
    (fused_kernel.ext_launcher, one-row halos, an exchange per step) runs
    instead at temporal=1, where NY is no multiple of WIDE_COLUMNS and
    where a shard has fewer than T rows: each a choice by shape, never a
    reaction to a failed launch. The attribute `temporal` is the depth that
    runs; the forms count their launches apart (EXT_LAUNCHES,
    EXT_TEMPORAL_LAUNCHES). A temporal that is no integer in [1,
    fused_kernel.FLAT_MAX_TEMPORAL], or on a card a pass deeper than the
    tile takes, raises ValueError. Every result is bitwise the same.

    Usage:
        sess = ShardedSession(cfg, walls, mesh=make_mesh(devices=["cuda:0"] * 4),
                              wall_spec=spec)
        sess.load(f); sess.advance(n); sess.block(); f = sess.state()
    """

    def __init__(self, cfg: LatticeConfig, walls, *, mesh: Mesh, overlap: bool = True,
                 wall_spec=None, slip_x=None, slip_y=None, fast_math: bool = False,
                 device=None, temporal: int | None = None):
        dtype = fused_kernel._storage(cfg)
        depth = SHARDED_TEMPORAL[dtype] if temporal is None else temporal
        fused_kernel._check_temporal(depth)
        L = shard_rows(cfg.nx, mesh.size)
        if (depth > 1 and cfg.ny % fused_kernel.WIDE_COLUMNS[dtype] == 0
                and L >= self._pass_rows(depth)):
            self.temporal = depth
        super().__init__(cfg, mesh, 1, dtype, overlap, device)
        self.moment_dtype = ops.moment_dtype(dtype)
        self.fast_math = fast_math
        if self.temporal > 1:
            for d in mesh.unique_devices():
                fused_kernel.check_ext_temporal_depth(self.temporal, dtype, d)
        geom = fused_kernel.host_geometry(cfg, walls, wall_spec, slip_x, slip_y)
        self._geoms = (self._shard_geometry(geom) if isinstance(geom, np.ndarray)
                       else [geom] * mesh.size)

    @staticmethod
    def _pass_rows(temporal: int) -> int:
        """The rows a shard needs for passes of `temporal` steps."""
        return temporal

    def _pack(self, comps):
        return comps[0]

    def _moments(self, shard, sites):
        return ops.probe_values(shard, sites)

    def _launcher(self, k, src, dst, halo, row0, rows, steps):
        if self.temporal == 1:
            return fused_kernel.ext_launcher(
                src, dst, halo, self._geoms[k], self.cfg, row0=row0, rows=rows,
                row_offset=k * self.L, fast_math=self.fast_math)
        return fused_kernel.ext_temporal_launcher(
            src, dst, halo, self._geoms[k], self.cfg, steps, row0=row0, rows=rows,
            row_offset=k * self.L, fast_math=self.fast_math)


class ShardedRdmaSession(ShardedSession):
    """ShardedSession on the rdma forms of the kernel: one launch per shard
    and pass that exchanges its own halo rows, so advance() makes no copy
    and no event. In passes of T = temporal steps (ShardedSession's
    default and checks) through the rdma temporal form
    (fused_kernel.rdma_temporal_launcher) wherever NY is a multiple of
    WIDE_COLUMNS and a shard has at least 2 T + 1 rows (an interior to
    hide the exchange behind); else one step a launch through the one-step
    rdma form (fused_kernel.rdma_launcher), and a shard of fewer than 3
    rows keeps ShardedSession's exchange-then-launch (sharded.py:335-336
    there). Per shard an RdmaEnd (comm rows or T-row blocks for both
    parities, flag and launch words) and, on cards, a stream of its own;
    neighbouring shards on different cards need peer access, and the
    session raises where a card refuses it. `step` counts the launches of
    each shard since load() (passes, or steps at temporal 1): the flag
    value and parity of the next. load() zeroes the flags and orders the
    shards' streams after the current streams; state(), unload() and
    block() wait for them, and raise RuntimeError when an edge tile gave up
    waiting for a neighbour's rows (`timeout_s`). On a CPU mesh the plain
    version stands in: every shard's send, then every shard's pass."""

    @staticmethod
    def _pass_rows(temporal: int) -> int:
        """An interior to hide the exchange behind: 2 T + 1 rows."""
        return 2 * temporal + 1

    def __init__(self, cfg: LatticeConfig, walls, *, mesh: Mesh, wall_spec=None, slip_x=None,
                 slip_y=None, fast_math: bool = False, device=None,
                 timeout_s: float = fused_kernel.RDMA_TIMEOUT_S, temporal: int | None = None):
        super().__init__(cfg, walls, mesh=mesh, overlap=False, wall_spec=wall_spec,
                         slip_x=slip_x, slip_y=slip_y, fast_math=fast_math, device=device,
                         temporal=temporal)
        self.rdma = self.temporal > 1 or self.L >= 3
        self.timeout_s = timeout_s
        self.step = 0
        self._ends = self._streams = None
        self._read = False
        if not self.rdma:
            return
        depth = None if self.temporal == 1 else self.temporal
        self._ends = [fused_kernel.rdma_end(cfg, d, depth=depth) for d in mesh.devices]
        self._card_shards = [mesh.devices.count(d) for d in mesh.devices]
        if self.device.type == "cuda":
            self._streams = [torch.cuda.Stream(d) for d in mesh.devices]
            n = mesh.size
            for k, d in enumerate(mesh.devices):
                for peer in (mesh.devices[(k - 1) % n], mesh.devices[(k + 1) % n]):
                    fused_kernel.enable_peer_access(d, peer)

    def _plan(self, parity: int, steps: int):
        """The rdma launches of a pass of `steps` steps that reads buffer
        `parity`: one per shard, grouped by device."""
        if not self.rdma:
            return super()._plan(parity, steps)
        n, L = self.mesh.size, self.L
        src, dst = self._bufs[parity][0], self._bufs[1 - parity][0]
        plan = {}
        for k, dev in enumerate(self.mesh.devices):
            args = (src[k], dst[k], self._ends[k], self._ends[(k - 1) % n],
                    self._ends[(k + 1) % n], self._geoms[k], self.cfg)
            options = dict(row_offset=k * L, fast_math=self.fast_math, timeout_s=self.timeout_s,
                           stream=None if self._streams is None else self._streams[k])
            with _on(dev):
                if self.temporal == 1:
                    call = fused_kernel.rdma_launcher(*args, **options)
                else:
                    call = fused_kernel.rdma_temporal_launcher(
                        *args, steps, card_shards=self._card_shards[k], **options)
            plan.setdefault(dev, []).append(call)
        return list(plan.items())

    def _current_streams(self):
        return [torch.cuda.current_stream(d) for d in self.mesh.unique_devices()]

    def _join(self) -> None:
        """The current streams wait for the shards' streams."""
        if self._streams is not None:
            for cur in self._current_streams():
                for s in self._streams:
                    cur.wait_stream(s)

    def _fork(self) -> None:
        """The shards' streams wait for every card's current stream: a
        launch also writes its neighbours' ends."""
        if self._streams is not None:
            for cur in self._current_streams():
                for s in self._streams:
                    s.wait_stream(cur)

    def _raise_on_timeout(self) -> None:
        if self._ends is None:
            return
        for k, end in enumerate(self._ends):
            step = fused_kernel.rdma_timed_out(end)
            if step:
                what = "step" if self.temporal == 1 else "pass"
                raise RuntimeError(
                    f"shard {k}: an edge row of {what} {step} waited {self.timeout_s} s for a "
                    "neighbour's halo rows and gave up; the state is not valid (did every "
                    f"shard of the ring launch that {what}?)")

    def load(self, f) -> None:
        self._join()
        super().load(f)
        if self.rdma:
            for end in self._ends:
                fused_kernel.rdma_reset(end)
            self.step = 0
            self._fork()

    def advance(self, n_steps: int) -> None:
        """n_steps in passes (_passes), one launch per shard and pass, each
        with the next flag value; no copy, no event, no host sync."""
        if not self.rdma:
            return super().advance(n_steps)
        if self._read:
            self._fork()  # the caller's reads of shards() come first
            self._read = False
        for steps in self._passes(n_steps):
            self.step += 1
            plan = self._plan_for(steps)
            if self._streams is None:
                calls = [call for _, calls in plan for call in calls]
                for call in calls:
                    call.send(self.step)
                for call in calls:
                    call.compute(self.step)
            else:
                for dev, calls in plan:
                    with _on(dev):
                        for call in calls:
                            call(self.step)
            self._parity ^= 1

    def block(self) -> None:
        super().block()
        self._raise_on_timeout()

    def state(self):
        self._join()
        out = super().state()
        self._fork()  # the next launches overwrite what the gather reads
        self._raise_on_timeout()
        return out

    def shards(self) -> list:
        """As ShardedSession.shards, ordered after the shards' streams;
        the next advance() orders the shards' streams after what the
        caller reads of them."""
        self._join()
        self._raise_on_timeout()
        self._read = True
        return super().shards()

    def probe_values(self, sites):
        """As ShardedSession.probe_values, ordered after the shards'
        streams as state() is; a spin that timed out raises at block()."""
        self._join()
        out = super().probe_values(sites)
        self._fork()  # as in state()
        return out

    def unload(self):
        out = super().unload()
        self._ends = None
        return out


class ShardedDSSession(_ShardedKernelSession):
    """Persistent sharded pair state of the ds kernel's ext-halo forms
    over a mesh, the twin of fused_ds_kernel.Session for the row-sharded
    path (and of the JAX sharded_run_steps): the masked variant when the
    mask has a solid site (codes 0/1, static halo class rows), `exact`
    selecting the tier, overlap the schedule (default False, the JAX
    runner's exchange-then-launch: faster on an H100 at 800x4000 than the
    interior and two bands of each pass, PERF.md row 3'-T). Needs a
    float64 config (the host-side precision of the pair).

    temporal (default DS_TEMPORAL, the JAX runner's): n steps run as n //
    T passes of T steps and one of n % T through the ext-halo temporal
    form (fused_ds_kernel.ext_temporal_launcher), each shard's T-row pair
    halos and static (T, NY) class rows beside them, the halos exchanged
    once per pass. The one-step ext-halo form (ext_launcher, one-row
    halos, an exchange per step) runs instead at temporal=1, where NY is
    no multiple of 4, where a shard has fewer than T rows and at the exact
    tier (whose passes lose to its one-step kernel on an H100, as
    fused_ds_kernel.Session's do): each a choice by shape or tier, never a
    reaction to a failed launch. The attribute `temporal` is the depth
    that runs; the two forms count their launches apart (EXT_LAUNCHES,
    EXT_TEMPORAL_LAUNCHES). A temporal that is no integer in [1,
    fused_kernel.FLAT_MAX_TEMPORAL], or on a card a pass deeper than the
    tile takes, raises ValueError. Every result is bitwise the same."""

    def __init__(self, cfg: LatticeConfig, walls, *, mesh: Mesh, exact: bool = False,
                 overlap: bool = False, device=None,
                 temporal: int = fused_ds_kernel.DS_TEMPORAL):
        fused_ds_kernel._require_float64(cfg)
        fused_kernel._check_temporal(temporal)
        L = shard_rows(cfg.nx, mesh.size)
        if (temporal > 1 and fused_ds_kernel.temporal_form_takes(cfg.ny) and L >= temporal
                and not exact):
            self.temporal = temporal
        super().__init__(cfg, mesh, 2, torch.float32, overlap, device)
        self.moment_dtype = torch.float64  # the pair recombined
        plane = fused_kernel.host_geometry(cfg, walls)  # None without a solid site
        self.exact = exact
        self.has_walls = plane is not None
        if self.temporal > 1:
            for d in mesh.unique_devices():
                fused_ds_kernel.check_ext_temporal_depth(self.temporal, d, exact, self.has_walls)
        self._geoms = self._shard_geometry(plane) if self.has_walls else [None] * mesh.size

    def _pack(self, comps):
        return DS(*comps)

    def _moments(self, shard, sites):
        return ds_engine.probe_values(shard, sites)

    def _launcher(self, k, src, dst, halo, row0, rows, steps):
        if self.temporal == 1:
            return fused_ds_kernel.ext_launcher(
                src, dst, halo, self._geoms[k], self.cfg, has_walls=self.has_walls,
                exact=self.exact, row0=row0, rows=rows)
        return fused_ds_kernel.ext_temporal_launcher(
            src, dst, halo, self._geoms[k], self.cfg, steps, has_walls=self.has_walls,
            exact=self.exact, row0=row0, rows=rows)


def _class_masks(plane):
    """A uint8 class plane as (walls, slip_x, slip_y) masks."""
    plane = np.asarray(fused_kernel._host_mask(plane))
    return plane == 1, plane == 2, plane == 3


def _kernel_session(cfg, walls, *, mesh: Mesh, overlap: bool, rdma: bool, **options):
    """A ShardedRdmaSession (rdma; it overlaps inside its kernel, so
    `overlap` does not apply) or a ShardedSession."""
    if rdma:
        return ShardedRdmaSession(cfg, walls, mesh=mesh, **options)
    return ShardedSession(cfg, walls, mesh=mesh, overlap=overlap, **options)


def make_cuda_run_steps(mesh: Mesh, cfg: LatticeConfig, *, overlap: bool = True,
                        wall_spec=None, has_slip: bool = False, fast_math: bool = False,
                        rdma: bool = False, temporal: int | None = None):
    """(f, walls, n_steps) -> f through a ShardedSession over the mesh
    (twin of make_pallas_run_steps), with rdma=True a ShardedRdmaSession:
    walls is the bool mask, or with has_slip the uint8 class plane
    (fused_kernel.class_plane); temporal as the sessions' (default
    SHARDED_TEMPORAL by storage, as make_pallas_run_steps' temporal=None).
    On CUDA meshes the kernels run; on a CPU mesh their plain versions
    (fused_kernel.temporal_reference_ext, temporal_reference_rdma's halves,
    or the one-step forms') stand in, as fused_kernel.Session does on the
    CPU."""
    shard_rows(cfg.nx, mesh.size)

    def run_steps(f, walls, n_steps: int):
        slips = {}
        if has_slip:
            walls, sx, sy = _class_masks(walls)
            slips = {"slip_x": sx, "slip_y": sy}
        sess = _kernel_session(cfg, walls, mesh=mesh, overlap=overlap, rdma=rdma,
                               wall_spec=wall_spec, fast_math=fast_math, device=f.device,
                               temporal=temporal, **slips)
        sess.load(f)
        sess.advance(n_steps)
        return sess.unload()

    return run_steps


def make_cuda_backend(mesh: Mesh | None = None, *, overlap: bool = True, rdma: bool = False,
                      temporal: int | None = None):
    """The sharded kernel path as a Simulation backend (twin of
    make_pallas_backend): run(f, walls, cfg, n_steps, wall_spec=None,
    slip_x=None, slip_y=None, fast_math=False) for one-shot callers, and
    run.session(cfg, walls, *, device, **options), the persistent
    ShardedSession (rdma=True: ShardedRdmaSession) the facade keeps, in
    passes of `temporal` steps (default SHARDED_TEMPORAL by storage).
    `mesh` defaults to make_mesh() at the call."""

    def session(cfg, walls, *, device=None, **options):
        m = make_mesh() if mesh is None else mesh
        return _kernel_session(cfg, walls, mesh=m, overlap=overlap, rdma=rdma, device=device,
                               temporal=temporal, **options)

    def run(f, walls, cfg, n_steps, **options):
        sess = session(cfg, walls, device=f.device, **options)
        sess.load(f)
        sess.advance(n_steps)
        return sess.unload()

    run.session = session
    return run


def make_cuda_ds_run_steps(mesh: Mesh, cfg: LatticeConfig, *, exact: bool = False,
                           overlap: bool = False, temporal: int = fused_ds_kernel.DS_TEMPORAL):
    """(f: DS, walls, n_steps) -> DS through a ShardedDSSession over the
    mesh (twin of fused_ds_kernel.sharded_run_steps), in passes of
    `temporal` steps where the temporal form applies; on a CPU mesh the
    plain versions stand in."""
    shard_rows(cfg.nx, mesh.size)

    def run_steps(f: DS, walls, n_steps: int) -> DS:
        sess = ShardedDSSession(cfg, walls, mesh=mesh, exact=exact, overlap=overlap,
                                device=f.hi.device, temporal=temporal)
        sess.load(f)
        sess.advance(n_steps)
        return sess.unload()

    return run_steps


def make_cuda_ds_backend(mesh: Mesh | None = None, *, exact: bool = False, overlap: bool = False,
                         temporal: int = fused_ds_kernel.DS_TEMPORAL):
    """The sharded ds kernel path as a Simulation backend: run(f, walls,
    cfg, n_steps) and run.session(cfg, walls, *, device) (see
    make_cuda_backend). The fast tier by default, in passes of
    DS_TEMPORAL steps, as on 'sharded-pallas-ds64'; overlap selects the
    schedule (ShardedDSSession)."""

    def session(cfg, walls, *, device=None):
        m = make_mesh() if mesh is None else mesh
        return ShardedDSSession(cfg, walls, mesh=m, exact=exact, overlap=overlap, device=device,
                                temporal=temporal)

    def run(f, walls, cfg, n_steps):
        sess = session(cfg, walls, device=f.hi.device)
        sess.load(f)
        sess.advance(n_steps)
        return sess.unload()

    run.session = session
    return run


__all__ = [
    "UP_SPEEDS", "DOWN_SPEEDS", "Mesh", "make_mesh", "shard_rows", "shard_state",
    "gather_state", "exchange_halos", "make_run_steps", "make_backend", "HaloExchange",
    "ShardedSession", "ShardedRdmaSession", "ShardedDSSession", "make_cuda_run_steps", "make_cuda_backend",
    "SHARDED_TEMPORAL",
    "make_cuda_ds_run_steps", "make_cuda_ds_backend",
]
