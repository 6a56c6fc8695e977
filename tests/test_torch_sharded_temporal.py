"""The f32/bf16 shard pass on the CPU: passes of L steps on a shard of the
row-sharded path with T-row halos, one halo exchange per pass (the
ext-halo temporal form) or none (the rdma temporal form).

csrc/lbm_temporal_step.cu's ext-halo form runs a pass of L <= Td steps on
one shard, the rows beyond it from two (9, Td, NY) halo blocks and their
class rows; fused_kernel.temporal_reference_ext (L chained step_reference
calls on the halo-extended block) is its plain version and
temporal_reference_ext_blocked its tiling in plain PyTorch.
csrc/lbm_temporal_rdma_step.cu's rdma form sends a shard's first and last L
rows into its ring neighbours' comm blocks inside the kernel;
temporal_reference_rdma (every shard's send, then every shard's pass from
what it received) is its plain version. Here:
- the plain versions bitwise against the local chain
  (fused_kernel.temporal_reference) over rings of 1, 2 and 4 shards, f32
  and bf16, wall-free, class plane, wall spec and slip codes, L 1-4; the
  tiling bitwise against the chain over whole shards, edge bands and
  interiors;
- the rdma plain version's comm rows, flags and parities, also with one
  shard a pass ahead of its neighbours;
- ShardedSession (both schedules) and ShardedRdmaSession on CPU meshes of
  1, 2 and 4 shards in passes of SHARDED_TEMPORAL (3 in f32, 2 in bf16),
  launches and halo copies counted, bitwise equal to fused_kernel.run_steps
  (the "cuda" backend's plain version) and to temporal=1; the one-step
  forms where the passes do not apply;
- in float32, "sharded-cuda" and "sharded-cuda-fused" against the JAX
  sharded-pallas-interpret and -fused-interpret backends (T=3 on both
  sides); bf16 against the port's own paths only: the JAX planner rounds
  bf16 every second step (ROADMAP, "Not to port");
- the launchers' refusals;
- the shard forms' tile plan (fused_kernel.shard_tile_plan, the twin of
  csrc/lbm_temporal.cuh's plan_tiles) against a brute force over every
  tile height, tile by tile, and both blocked plain versions at planned
  tiles bitwise against the chains.
tests/test_torch_cuda.py holds the kernels against these plain versions on
a card. The bar is bitwise throughout: both sides run the same float32
operations in the same order.
"""

import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu import Simulation as JaxSimulation
from latticeboltzmann_tpu.models import engine as jax_engine
from latticeboltzmann_tpu.parallel import sharded as jax_sharded
from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.models import engine
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
from latticeboltzmann_tpu_torch.ops.fused_kernel import ShardPlane
from latticeboltzmann_tpu_torch.parallel import sharded
from latticeboltzmann_tpu_torch.utils import interop

torch.set_num_threads(1)

DTYPES = {"f32": np.float32, "bf16": "bfloat16"}
KINDS = ("wall-free", "plane", "spec", "slip")
# a small tile: output tiles of (9 - 2L) x (24 - 2 column_halo(L)) sites
# (f32: 16 columns at L <= 4; bf16: 8); it takes passes of up to 4 steps
SMALL_TILE = fk.FlatTile(9, 24)


def _rows(x, a, b):
    """Rows [a, b) of x along dim -2, modulo its rows."""
    return x[..., [r % x.shape[-2] for r in range(a, b)], :].contiguous()


def _scene(nx, ny, dtype, seed=0):
    """(cfg, state, {kind: geometry}): a perturbed state with the forcing
    guard off at column 0 on both sides of the 2- and 4-shard boundaries;
    geometries: none, a class plane of a channel whose walls reach column 0
    across the 2-shard boundary, the reference barrier's wall spec, and
    slip codes (a slip_x top row, a slip_y block across that boundary)."""
    cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype, accel=0.005)
    rng = np.random.default_rng(seed)
    f0 = initial_state(cfg) * (1 + 0.05 * rng.uniform(-1, 1, (9, nx, ny)))
    f0[6, [nx // 4 - 1, nx // 4, nx // 2 - 1, nx // 2], 0] = 1e-6
    f = interop.state_tensor(f0.astype(np.float32), cfg.dtype, "cpu")
    walls = geometry.channel(nx, ny)
    walls[nx // 2 - 2:nx // 2 + 2, 0:3] = True
    slip = walls.copy()
    slip_x = np.zeros_like(walls)
    slip_x[0], slip[0] = True, False
    slip_y = np.zeros_like(walls)
    slip_y[nx // 2 - 1:nx // 2 + 1, ny // 2:ny // 2 + 3] = True
    return cfg, f, {"wall-free": None, "plane": torch.as_tensor(fk.class_plane(walls)),
                    "spec": geometry.infer_spec(geometry.reference_barrier(nx, ny)),
                    "slip": torch.as_tensor(fk.class_plane(slip, slip_x, slip_y))}


def _shard(f, g, n, k, depth):
    """Shard k of a ring of n: (its block, its (top, bot) halo blocks of
    `depth` rows, its geometry: a ShardPlane with (depth, NY) class rows,
    or the wall spec or None as they are)."""
    L = f.shape[1] // n
    r0 = k * L
    halo = (_rows(f, r0 - depth, r0), _rows(f, r0 + L, r0 + L + depth))
    if torch.is_tensor(g):
        g = ShardPlane(_rows(g, r0, r0 + L), _rows(g, r0 - depth, r0),
                       _rows(g, r0 + L, r0 + L + depth))
    return _rows(f, r0, r0 + L), halo, g


# ---- the plain versions ----

@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_ext_chain_on_each_shard_equals_the_local_pass(dt, kind, n):
    """temporal_reference_ext on each shard of a ring of n, halos of 4 rows
    from the ring neighbours (on one shard its own rows), bitwise equal to
    the shard's rows of the local temporal_reference over the whole lattice
    at every L 1-4; the wall spec at global rows, halo rows included."""
    cfg, f, geoms = _scene(24, 40, DTYPES[dt])
    g = geoms[kind]
    Ls = 24 // n
    for L in range(1, 5):
        want = fk.temporal_reference(f, g, cfg, L)
        for k in range(n):
            src, halo, geom = _shard(f, g, n, k, 4)
            got = fk.temporal_reference_ext(src, halo, geom, cfg, L, row_offset=k * Ls)
            assert torch.equal(got, want[:, k * Ls:(k + 1) * Ls]), (L, k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_ext_blocked_equals_the_ext_chain(dt, kind):
    """temporal_reference_ext_blocked at the small tile, Td = L, bitwise
    equal to temporal_reference_ext at every L it takes (1-4) on both
    shards of a ring of 2 at 16x40 (8-row shards): over the whole shard,
    the two L-row edge bands and the interior between them (where there is
    one). The last column of tiles holds column 0 in its right halo."""
    cfg, f, geoms = _scene(16, 40, DTYPES[dt])
    for L in range(1, fk.tile_max_steps(SMALL_TILE, fk._storage(cfg)) + 1):
        for k in range(2):
            src, halo, geom = _shard(f, geoms[kind], 2, k, L)
            want = fk.temporal_reference_ext(src, halo, geom, cfg, L, row_offset=8 * k)
            ranges = [(0, 8), (0, L), (8 - L, L)] + ([(L, 8 - 2 * L)] if 8 > 2 * L else [])
            for row0, rows in ranges:
                got = fk.temporal_reference_ext_blocked(src, halo, geom, cfg, L, SMALL_TILE,
                                                        row_offset=8 * k, row0=row0, rows=rows)
                assert torch.equal(got, want[:, row0:row0 + rows]), (L, k, row0, rows)


def test_plain_versions_refuse_reads_past_the_halos():
    cfg, f, geoms = _scene(24, 40, np.float32)
    src, halo, geom = _shard(f, geoms["plane"], 2, 0, 2)
    with pytest.raises(ValueError, match="halos hold 2"):
        fk.temporal_reference_ext(src, halo, geom, cfg, 3)
    with pytest.raises(ValueError, match="past the 2-row halos"):
        fk.temporal_reference_ext_blocked(src, halo, geom, cfg, 3, SMALL_TILE)
    with pytest.raises(ValueError, match="outside"):
        fk.temporal_reference_ext_blocked(src, halo, geom, cfg, 2, SMALL_TILE, row0=10, rows=3)
    with pytest.raises(ValueError, match="leaves no output tile"):
        fk.temporal_reference_ext_blocked(src, halo, geom, cfg, 2, fk.FlatTile(4, 24))


# ---- the rdma form's plain version ----

def test_rdma_temporal_schedule():
    """A pass of L steps sends the first L rows up into rows [0, L) of the
    upper neighbour's bot block and the last L rows down into rows [Td - L,
    Td) of the lower neighbour's top block; the parity alternates with the
    pass and the flag value is the pass itself."""
    s = fk.rdma_temporal_schedule(200, 3, 2, 5)
    assert (s["parity"], s["flag"], s["up"], s["down"]) == (1, 5, -1, 1)
    assert s["send_up_rows"] == s["up_bot_rows"] == (0, 2)
    assert s["send_down_rows"] == (198, 200) and s["down_top_rows"] == (1, 3)
    assert (s["top_flag"], s["bot_flag"]) == (0, 1)
    assert [fk.rdma_temporal_schedule(8, 3, 3, t)["parity"] for t in (1, 2, 3)] == [1, 0, 1]


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("kind", ["plane", "spec", "slip"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_rdma_plain_version_equals_the_ext_path(dt, kind, n):
    """temporal_reference_rdma over a ring of n, passes of T, T, 1, T (T =
    SHARDED_TEMPORAL), bitwise equal to the local chain and so to the
    ext-halo path; after each pass the comm blocks of its parity hold the
    neighbours' edge rows in the rows the pass reads, both flags the pass
    number, and the launch words stay zero."""
    cfg, f, geoms = _scene(24, 40, DTYPES[dt], seed=1)
    T = sharded.SHARDED_TEMPORAL[fk._storage(cfg)]
    g, Ls = geoms[kind], 24 // n
    ends = [fk.rdma_end(cfg, "cpu", depth=T) for _ in range(n)]
    shards = [_shard(f, g, n, k, T) for k in range(n)]
    srcs, plane_geoms = [s[0] for s in shards], [s[2] for s in shards]
    cur = f
    for p, L in enumerate((T, T, 1, T), 1):
        before = [s.clone() for s in srcs]
        srcs = fk.temporal_reference_rdma(srcs, ends, plane_geoms, cfg, L, p)
        cur = fk.temporal_reference(cur, g, cfg, L)
        assert torch.equal(torch.cat(srcs, 1), cur), p
        for k in range(n):
            top, bot = ends[k].top[p % 2], ends[k].bot[p % 2]
            assert torch.equal(top[:, T - L:], before[(k - 1) % n][:, Ls - L:])
            assert torch.equal(bot[:, :L], before[(k + 1) % n][:, :L])
            assert ends[k].flags.tolist() == [p, p] and not ends[k].work.any()
    with pytest.raises(RuntimeError, match="have not arrived"):
        fk.rdma_temporal_compute_reference(srcs[0], ends[0], plane_geoms[0], cfg, T, 5)


@pytest.mark.parametrize("n", [2, 4])
def test_a_shard_one_pass_ahead_overwrites_nothing_unread(n):
    """The reuse discipline of the comm blocks, pass by pass: shard 0 runs
    pass 1 and sends pass 2 before its neighbours have read their pass-1
    rows; they still find them intact (the other parity), shard 0 cannot
    run pass 2 until they send it, and the ring ends bitwise equal to the
    local chain."""
    cfg, f, geoms = _scene(24, 40, np.float32, seed=2)
    g, T = geoms["spec"], 3
    ends = [fk.rdma_end(cfg, "cpu", depth=T) for _ in range(n)]
    srcs = [_shard(f, g, n, k, T)[0] for k in range(n)]
    Ls = 24 // n

    def send(k, p, src):
        fk.rdma_temporal_send_reference(src, ends[(k - 1) % n], ends[(k + 1) % n], T, p)

    def compute(k, p, src):
        return fk.rdma_temporal_compute_reference(src, ends[k], g, cfg, T, p, row_offset=k * Ls)

    for k in range(n):
        send(k, 1, srcs[k])
    out = {0: compute(0, 1, srcs[0])}
    send(0, 2, out[0])  # into parity 0, while the neighbours read parity 1
    with pytest.raises(RuntimeError, match="have not arrived"):
        compute(0, 2, out[0])
    for k in range(1, n):
        out[k] = compute(k, 1, srcs[k])
    for k in range(1, n):
        send(k, 2, out[k])
    final = [compute(k, 2, out[k]) for k in range(n)]
    assert torch.equal(torch.cat(final, 1), fk.temporal_reference(f, g, cfg, 2 * T))


def test_rdma_end_of_depth():
    cfg = LatticeConfig(nx=24, ny=40, dtype="bfloat16")
    end = fk.rdma_end(cfg, "cpu", depth=3)
    assert tuple(end.top.shape) == tuple(end.bot.shape) == (2, 9, 3, 40)
    assert end.top.dtype == torch.bfloat16
    assert tuple(end.flags.shape) == (2,) and tuple(end.work.shape) == (fk.RDMA_TEMPORAL_WORDS,)
    assert tuple(fk.rdma_end(cfg, "cpu").work.shape) == (fk.RDMA_WORDS,)
    for depth in (0, 2.0, True):
        with pytest.raises(ValueError, match="depth"):
            fk.rdma_end(cfg, "cpu", depth=depth)


# ---- the launchers on the CPU ----

def test_ext_temporal_launcher_on_the_cpu_writes_its_rows():
    """The CPU path of the launcher writes temporal_reference_ext's rows of
    its range and nothing else: an interior range needs no halo; the edge
    bands take it; no launch is counted."""
    cfg, f, geoms = _scene(24, 40, np.float32)
    src, halo, geom = _shard(f, geoms["slip"], 2, 1, 3)
    want = fk.temporal_reference_ext(src, halo, geom, cfg, 3, row_offset=12)
    before = (fk.EXT_TEMPORAL_LAUNCHES, fk.EXT_TEMPORAL_STEPS, fk.EXT_LAUNCHES)
    dst = torch.full_like(src, float("nan"))
    fk.ext_temporal_launcher(src, dst, None, geom, cfg, 3, row0=3, rows=6, row_offset=12)()
    assert torch.equal(dst[:, 3:9], want[:, 3:9])
    assert torch.isnan(dst[:, :3]).all() and torch.isnan(dst[:, 9:]).all()
    for row0 in (0, 9):
        fk.ext_temporal_launcher(src, dst, halo, geom, cfg, 3, row0=row0, rows=3,
                                 row_offset=12)()
    assert torch.equal(dst, want)
    assert (fk.EXT_TEMPORAL_LAUNCHES, fk.EXT_TEMPORAL_STEPS, fk.EXT_LAUNCHES) == before


@pytest.mark.parametrize("case", [
    "deeper than the halos", "reads past the shard", "NY of no whole vectors", "aliased",
    "halo of another shape", "range outside", "row offset outside", "mask not a ShardPlane",
    "steps 0", "steps 2.5", "steps True", "float64"])
def test_ext_temporal_launcher_refusals(case):
    """Everything the form does not take raises ValueError (or, for a
    float64 config, NotImplementedError naming B15), and never runs the
    one-step form instead."""
    cfg, f, geoms = _scene(24, 40, np.float32)
    src, halo, geom = _shard(f, geoms["plane"], 2, 0, 2)
    dst = torch.empty_like(src)
    kw = dict(src=src, dst=dst, halo=halo, geom=geom, cfg=cfg, steps=2, row0=0, rows=None,
              row_offset=0)
    match = {"deeper than the halos": "halos hold 2", "reads past the shard": "give the halos",
             "NY of no whole vectors": "multiple of 4", "aliased": "distinct",
             "halo of another shape": "halo blocks", "range outside": "outside",
             "row offset outside": "outside", "mask not a ShardPlane": "ShardPlane",
             "float64": "B15"}.get(case, "temporal")
    if case == "deeper than the halos":
        kw["steps"] = 3
    elif case == "reads past the shard":
        kw.update(halo=None, row0=1, rows=10)
    elif case == "NY of no whole vectors":
        cfg38, f38, g38 = _scene(24, 38, np.float32)
        src38, halo38, geom38 = _shard(f38, g38["plane"], 2, 0, 2)
        kw.update(src=src38, dst=torch.empty_like(src38), halo=halo38, geom=geom38, cfg=cfg38)
    elif case == "aliased":
        kw["dst"] = src
    elif case == "halo of another shape":
        kw["halo"] = (halo[0], halo[1][:, :1].contiguous())
    elif case == "range outside":
        kw.update(row0=8, rows=6)
    elif case == "row offset outside":
        kw["row_offset"] = 20
    elif case == "mask not a ShardPlane":
        kw["geom"] = geom.plane
    elif case.startswith("steps"):
        kw["steps"] = {"steps 0": 0, "steps 2.5": 2.5, "steps True": True}[case]
    elif case == "float64":
        kw["cfg"] = LatticeConfig(nx=24, ny=40, dtype=np.float64)
    error = NotImplementedError if case == "float64" else ValueError
    with pytest.raises(error, match=match):
        fk.ext_temporal_launcher(kw.pop("src"), kw.pop("dst"), kw.pop("halo"), kw.pop("geom"),
                                 kw.pop("cfg"), kw.pop("steps"), **kw)


def test_rdma_temporal_launcher_refusals():
    """A shard of fewer rows than the pass sends, a pass deeper than the
    ends, the one-step form's ends, neighbours' ends of another depth and
    a card_shards that is none raise ValueError; a ring of one runs."""
    cfg, f, geoms = _scene(24, 40, np.float32)
    src = f.clone()
    dst = torch.empty_like(src)
    end = fk.rdma_end(cfg, "cpu", depth=3)
    call = fk.rdma_temporal_launcher(src, dst, end, end, end, geoms["spec"], cfg, 3,
                                     card_shards=1)
    call(1)
    assert torch.equal(dst, fk.temporal_reference(f, geoms["spec"], cfg, 3))
    with pytest.raises(ValueError, match="the shard has 2"):
        small = LatticeConfig(nx=2, ny=40, dtype=np.float32)
        s2 = torch.as_tensor(initial_state(small))
        e2 = fk.rdma_end(small, "cpu", depth=3)
        fk.rdma_temporal_launcher(s2, torch.empty_like(s2), e2, e2, e2, None, small, 3,
                                  card_shards=1)
    with pytest.raises(ValueError, match="halos hold 3"):
        fk.rdma_temporal_launcher(src, dst, end, end, end, None, cfg, 4, card_shards=1)
    one_step = fk.rdma_end(cfg, "cpu")
    with pytest.raises(ValueError, match="halo blocks"):
        fk.rdma_temporal_launcher(src, dst, one_step, end, end, None, cfg, 1, card_shards=1)
    with pytest.raises(ValueError, match="comm rows"):
        fk.rdma_temporal_launcher(src, dst, end, fk.rdma_end(cfg, "cpu", depth=2), end, None,
                                  cfg, 2, card_shards=1)
    for bad in (0, True, 1.0):
        with pytest.raises(ValueError, match="card_shards"):
            fk.rdma_temporal_launcher(src, dst, end, end, end, None, cfg, 3, card_shards=bad)


# ---- the sessions ----

def _record(monkeypatch):
    """Every launch of the shard forms from here on, in order: ("ext-pass",
    steps, row0, rows), ("ext-step", 1, row0, rows), ("rdma-pass", steps)
    and ("rdma-step", 1) (the rdma calls recorded at their send half)."""
    calls = []
    real = {name: getattr(fk, name) for name in ("ext_temporal_launcher", "ext_launcher",
                                                 "rdma_temporal_launcher", "rdma_launcher")}

    def ext(name, tag):
        def make(src, dst, halo, geom, cfg, *args, **kw):
            call = real[name](src, dst, halo, geom, cfg, *args, **kw)
            steps = args[0] if args else 1
            rows = kw.get("rows") or src.shape[1] - kw.get("row0", 0)
            entry = (tag, steps, kw.get("row0", 0), rows)
            return lambda: (calls.append(entry), call())
        return make

    def rdma(name, tag):
        def make(*args, **kw):
            call = real[name](*args, **kw)
            entry = (tag, args[7] if len(args) > 7 else 1)

            def launch(p):
                calls.append(entry)
                call(p)

            def send(p):
                calls.append(entry)
                call.send(p)

            launch.send, launch.compute = send, call.compute
            return launch
        return make

    monkeypatch.setattr(fk, "ext_temporal_launcher", ext("ext_temporal_launcher", "ext-pass"))
    monkeypatch.setattr(fk, "ext_launcher", ext("ext_launcher", "ext-step"))
    monkeypatch.setattr(fk, "rdma_temporal_launcher", rdma("rdma_temporal_launcher", "rdma-pass"))
    monkeypatch.setattr(fk, "rdma_launcher", rdma("rdma_launcher", "rdma-step"))
    return calls


def _schedule(path, n, L, passes):
    """The launches a session of n shards of L rows makes for `passes`
    (their steps): per shard and pass the interior [s, L - s) and two
    s-row bands ("sharded-cuda"), one launch ("sharded-cuda-fused"), or
    one rdma launch."""
    out = []
    for s in passes:
        for _ in range(n):
            if path == "sharded-cuda-rdma":
                out.append(("rdma-pass", s))
            elif path == "sharded-cuda" and L >= 2 * s + 1:
                out += [("ext-pass", s, s, L - 2 * s), ("ext-pass", s, 0, s),
                        ("ext-pass", s, L - s, s)]
            else:
                out.append(("ext-pass", s, 0, L))
    return sorted(out)


def _session(path, cfg, walls, n, **kw):
    mesh = sharded.make_mesh(devices=["cpu"] * n)
    if path == "sharded-cuda-rdma":
        return sharded.ShardedRdmaSession(cfg, walls, mesh=mesh, **kw)
    return sharded.ShardedSession(cfg, walls, mesh=mesh, overlap=path == "sharded-cuda", **kw)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("path", ["sharded-cuda", "sharded-cuda-fused", "sharded-cuda-rdma"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_sessions_run_passes_equal_to_run_steps_and_temporal_1(dt, path, n, monkeypatch):
    """Each backend's session on a CPU mesh of n shards (48 rows: shards of
    48, 24, 12) in passes of T = SHARDED_TEMPORAL (3 in f32, 2 in bf16):
    advance(7) then advance(5), n // T passes of T and one of the rest,
    every launch of the temporal forms (interior + two T-row bands, one
    launch a shard, or one rdma launch a shard and pass) and none of the
    one-step forms; the ext-halo paths copy 2 T-row halo blocks a shard
    and pass, the rdma path none; bitwise equal to fused_kernel.run_steps
    (the "cuda" backend's plain version) and to a temporal=1 session after
    each."""
    cfg, f, _ = _scene(48, 40, DTYPES[dt])
    walls = geometry.channel(48, 40)
    walls[20:26, 10:13] = True
    T = sharded.SHARDED_TEMPORAL[fk._storage(cfg)]
    sess = _session(path, cfg, walls, n, wall_spec=geometry.infer_spec(walls))
    one = _session(path, cfg, walls, n, wall_spec=geometry.infer_spec(walls), temporal=1)
    assert (sess.temporal, one.temporal) == (T, 1)
    calls = _record(monkeypatch)
    sess.load(f)
    one.load(f)
    done = n_passes = 0
    for steps in (7, 5):
        passes = (T,) * (steps // T) + ((steps % T,) if steps % T else ())
        n_passes += len(passes)
        del calls[:]
        before = sharded.HALO_COPIES
        sess.advance(steps)
        copies = sharded.HALO_COPIES - before
        assert sorted(calls) == _schedule(path, n, 48 // n, passes)
        assert copies == (0 if path == "sharded-cuda-rdma" else 2 * n * len(passes))
        one.advance(steps)
        done += steps
        got = sess.state()
        assert torch.equal(got, one.state())
        assert torch.equal(got, fk.run_steps(f, walls, cfg, done,
                                             wall_spec=geometry.infer_spec(walls)))
    if path == "sharded-cuda-rdma":
        assert sess.step == n_passes  # the flag value of the last launch


@pytest.mark.parametrize("case", ["NY 38", "shards under T rows", "rdma shards under 2T+1 rows",
                                  "temporal=1"])
def test_sessions_run_the_one_step_forms_where_passes_do_not_apply(case, monkeypatch):
    """An NY of no whole 16-byte vectors, shards of fewer than T rows (the
    ext-halo paths) or of fewer than 2 T + 1 rows (the rdma path) and
    temporal=1 run the one-step forms, a choice by shape: every recorded
    launch is a one-step one; bitwise equal to run_steps after 5 steps."""
    nx, ny, n, path, kw = {
        "NY 38": (16, 38, 2, "sharded-cuda", {}),
        "shards under T rows": (16, 40, 8, "sharded-cuda-fused", {}),
        "rdma shards under 2T+1 rows": (24, 40, 4, "sharded-cuda-rdma", {}),
        "temporal=1": (16, 40, 2, "sharded-cuda-rdma", {"temporal": 1})}[case]
    cfg, f, _ = _scene(nx, ny, np.float32)
    walls = geometry.channel(nx, ny)
    sess = _session(path, cfg, walls, n, **kw)
    assert sess.temporal == 1
    calls = _record(monkeypatch)
    sess.load(f)
    sess.advance(5)
    assert {c[0] for c in calls} == {"rdma-step" if path == "sharded-cuda-rdma" else "ext-step"}
    assert torch.equal(sess.unload(), fk.run_steps(f, walls, cfg, 5))


@pytest.mark.parametrize("temporal", [0, fk.FLAT_MAX_TEMPORAL + 1, 2.5, True])
def test_sessions_refuse_a_depth_that_is_none(temporal):
    cfg, _, _ = _scene(16, 40, np.float32)
    for path in ("sharded-cuda", "sharded-cuda-rdma"):
        with pytest.raises(ValueError, match="temporal"):
            _session(path, cfg, geometry.channel(16, 40), 2, temporal=temporal)


def test_facade_probed_run_ends_passes_at_samples(monkeypatch):
    """Simulation(backend="sharded-cuda-rdma") over 2 CPU shards:
    run_probed(6, every=2) runs a pass of 2 per sample (no pass crosses a
    sample), run(7) passes of 3, 3 and 1; the series and the state bitwise
    equal to "cuda"'s (the local kernel's plain version)."""
    monkeypatch.setattr(engine, "_KERNEL_BACKENDS", set())
    monkeypatch.setitem(engine._BACKENDS, "sharded-cuda-rdma",
                        sharded.make_cuda_backend(sharded.make_mesh(devices=["cpu"] * 2),
                                                  rdma=True))
    cfg, f, _ = _scene(32, 40, np.float32)
    walls = geometry.channel(32, 40)
    walls[12:20, 10:13] = True
    f0 = f.numpy()
    probes = [(3, 0), (15, 20), (31, 39)]
    calls = _record(monkeypatch)
    sims = {b: Simulation(cfg, walls, backend=b, device="cpu", f0=f0, allow_experimental=True)
            for b in ("sharded-cuda-rdma", "cuda")}
    series = {b: s.run_probed(6, probes, every=2) for b, s in sims.items()}
    assert calls == [("rdma-pass", 2)] * 2 * 3
    np.testing.assert_array_equal(series["sharded-cuda-rdma"], series["cuda"])
    del calls[:]
    for s in sims.values():
        s.run(7)
    assert calls == [("rdma-pass", 3)] * 4 + [("rdma-pass", 1)] * 2
    np.testing.assert_array_equal(sims["sharded-cuda-rdma"].state(), sims["cuda"].state())


# ---- against the JAX runner ----

@pytest.mark.parametrize("backend,jax_backend,n", [
    ("sharded-cuda", "sharded-pallas-interpret", 2),
    ("sharded-cuda-fused", "sharded-pallas-fused-interpret", 4)])
def test_sharded_passes_equal_jax_sharded_interpret(monkeypatch, backend, jax_backend, n):
    """float32, the wall spec (both facades infer it): the port's passes of
    3 over n CPU shards (7 steps: passes of 3, 3 and 1) against the JAX
    backend of the same schedule in interpret mode over a mesh of n (its
    passes of DEFAULT_TEMPORAL = 3, the remainder at one step a launch),
    bitwise; tests/test_torch_rdma.py's 32x40 scene (the JAX kernel needs
    8-row tiles per shard)."""
    make = {"sharded-pallas-interpret": lambda m: jax_sharded.make_pallas_backend(
                m, interpret=True),
            "sharded-pallas-fused-interpret": lambda m: jax_sharded.make_pallas_backend(
                m, interpret=True, overlap=False)}[jax_backend]
    monkeypatch.setitem(jax_engine._BACKENDS, jax_backend, make(jax_sharded.make_mesh(n)))
    monkeypatch.setattr(engine, "_KERNEL_BACKENDS", set())
    monkeypatch.setitem(engine._BACKENDS, backend, sharded.make_cuda_backend(
        sharded.make_mesh(devices=["cpu"] * n), overlap=backend == "sharded-cuda"))
    walls = geometry.channel(32, 40)
    walls[12:20, 10:13] = True
    f0 = initial_state(LatticeConfig(nx=32, ny=40, dtype=np.float32))
    f0[6, [7, 8, 15, 16], 0] = 1e-6
    ref = JaxSimulation(JaxConfig(nx=32, ny=40, dtype=np.float32), walls, backend=jax_backend,
                        f0=f0)
    sim = Simulation(LatticeConfig(nx=32, ny=40, dtype=np.float32), walls, backend=backend,
                     device="cpu", f0=f0)
    assert sim.wall_spec == ref.wall_spec is not None
    got = sim.run(7).state()
    assert sim._session.temporal == 3
    np.testing.assert_array_equal(got, np.asarray(ref.run(7).state()))


# ---- the shard forms' tile plan ----

def _walks(count, ctas):
    """The tiles each of `ctas` CTAs walks when CTA i takes tiles i, i +
    ctas, ... of `count`."""
    walked = [0] * ctas
    for j in range(count):
        walked[j % ctas] += 1
    return walked


def _brute_force_plan(dt, rows, ny, L, max_rows, slots, rdma, card_shards, width):
    """Every output tile height R's launch, counted tile by tile: the row
    blocks and their ragged heights, the edge blocks (those whose source
    rows leave the shard), the tiles each CTA walks; its cost waves x
    tile_cost, the tile's bytes and site updates counted vector by vector
    and level by level. Returns {R: record} for every R that gives a
    launch."""
    v = fk.WIDE_COLUMNS[dt]
    pad = -(-L // v) * v
    c = width - 2 * pad
    site = 9 * torch.empty((), dtype=dt).element_size()
    out = {}
    for r in range(1, max_rows - 2 * L + 1):
        blocks = [(r0, min(r, rows - r0)) for r0 in range(0, rows, r)]
        assert sum(h for _, h in blocks) == rows and all(1 <= h <= r for _, h in blocks)
        tiles_y = len(range(0, ny, c))
        vectors = {col // v for col in range(pad - L, pad + c + L)}
        n_bytes = (r + 2 * L) * len(vectors) * v * (site + 1) + r * c * site
        updates = sum((r + 2 * (L - t)) * (c + 2 * (L - t)) for t in range(1, L + 1))
        cost = max(fk.TILE_NS_PER_BYTE * n_bytes, fk.TILE_NS_PER_SITE[dt] * updates)
        assert fk.tile_cost(dt, r, L, width) == pytest.approx(cost, rel=1e-12)
        rec = {"output_rows": r, "rows": r + 2 * L, "tiles": len(blocks) * tiles_y}
        if rdma:
            edge_blocks = [i for i, (r0, h) in enumerate(blocks) if r0 - L < 0 or r0 + h + L > rows]
            grid = fk.rdma_tile_grid(dt, r, rows, ny, L, slots, card_shards, width)
            if (slots - 1) // card_shards < fk.RDMA_SENDERS:
                assert grid is None
                continue
            assert grid["edge_tiles"] == len(edge_blocks) * tiles_y
            assert grid["interior_tiles"] == rec["tiles"] - grid["edge_tiles"]
            # the deadlock rule: every CTA may spin, and every launch's CTAs
            # together leave a slot
            assert card_shards * grid["ctas"] <= slots - 1
            assert grid["ctas"] == min((slots - 1) // card_shards,
                                       fk.RDMA_SENDERS + rec["tiles"])
            rec.update(grid, waves=max(_walks(rec["tiles"], grid["ctas"])))
        else:
            ctas = min(rec["tiles"], slots)
            rec.update(ctas=ctas, waves=max(_walks(rec["tiles"], ctas)))
        rec["cost"] = rec["waves"] * fk.tile_cost(dt, r, L, width)
        out[r] = rec
    return out


@pytest.mark.parametrize("form", ["ext", "rdma-1", "rdma-4"])
@pytest.mark.parametrize("slots", [5, 40, 132])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("rows", [7, 24, 200])
def test_shard_tile_plan_equals_a_brute_force_over_every_tile(rows, L, dt, slots, form):
    """shard_tile_plan over shard rows, depth, storage, the card's slots and
    the ring's launches on the card: its tiles cover the launch's rows
    exactly at an output height R <= the largest tile's rows - 2 L, and it
    takes the R of the least waves x tile_cost (the larger on a tie) among
    every R a brute force counts tile by tile; its counts are that R's. On
    5 slots the rdma form has no plan: its 8 senders need more."""
    storage = fk._storage(LatticeConfig(nx=8, ny=8, dtype=DTYPES[dt]))
    rdma, card_shards = form != "ext", int(form[-1]) if form != "ext" else 1
    max_rows = {torch.float32: 43, torch.bfloat16: 84}[storage] if rows == 200 else 16
    width = 24 if rows < 200 else fk.TILE_WIDTH
    ny = 136
    plan = fk.shard_tile_plan(storage, rows, ny, L, max_rows, slots, rdma=rdma,
                              card_shards=card_shards, width=width)
    every = _brute_force_plan(storage, rows, ny, L, max_rows, slots, rdma, card_shards, width)
    if not every:  # too few slots for the rdma form's senders and a spare
        assert plan is None and rdma
        return
    least = min(rec["cost"] for rec in every.values())
    best = max(r for r, rec in every.items() if rec["cost"] == least)
    assert plan == every[best]
    assert 1 <= plan["output_rows"] <= max_rows - 2 * L
    assert plan["rows"] == plan["output_rows"] + 2 * L


def test_shard_tile_plan_costs_no_more_than_the_largest_tile():
    """A 200-row shard of 800x4000 at L = 3 in float32 on 132 CTA slots:
    the card's largest tile (43 rows: 37 output rows) lays 6 rows of tiles
    x 63 columns, 378 tiles in 3 waves; the planned tile costs no more,
    lays its tiles over the shard's rows, and a tile of 6 rows (no output
    row at L = 3) gives no plan."""
    planned = fk.shard_tile_plan(torch.float32, 200, 4000, 3, 43, 132)
    assert planned["cost"] <= 3 * fk.tile_cost(torch.float32, 37, 3)
    assert planned["tiles"] == -(-200 // planned["output_rows"]) * 63
    assert planned["ctas"] == 132 and planned["waves"] == -(-planned["tiles"] // 132)
    assert fk.shard_tile_plan(torch.float32, 200, 4000, 3, 6, 132) is None


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(24, 40), (48, 136)])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_blocked_plain_versions_at_planned_tiles_equal_the_chains(dt, shape, kind, n):
    """A pass of T = SHARDED_TEMPORAL steps on each shard of a ring of n at
    the tile each form plans (shard_tile_plan on 6 slots, the rdma form on
    40, tiles of at most 16 x 24 sites, so that both axes are tiled):
    temporal_reference_ext_blocked
    bitwise equal to temporal_reference_ext, and temporal_reference_rdma at
    the rdma form's planned tile bitwise equal to it without one, comm
    blocks and flags included."""
    nx, ny = shape
    cfg, f, geoms = _scene(nx, ny, DTYPES[dt], seed=3)
    storage = fk._storage(cfg)
    T = sharded.SHARDED_TEMPORAL[storage]
    g, Ls = geoms[kind], nx // n
    ext_plan = fk.shard_tile_plan(storage, Ls, ny, T, 16, 6, width=24)
    rdma_plan = fk.shard_tile_plan(storage, Ls, ny, T, 16, 40, rdma=True, card_shards=n, width=24)
    shards = [_shard(f, g, n, k, T) for k in range(n)]
    for k, (src, halo, geom) in enumerate(shards):
        want = fk.temporal_reference_ext(src, halo, geom, cfg, T, row_offset=k * Ls)
        got = fk.temporal_reference_ext_blocked(src, halo, geom, cfg, T,
                                                fk.FlatTile(ext_plan["rows"], 24),
                                                row_offset=k * Ls)
        assert torch.equal(got, want), k
    ends = {t: [fk.rdma_end(cfg, "cpu", depth=T) for _ in range(n)] for t in ("plain", "tiled")}
    srcs, plane_geoms = [s[0] for s in shards], [s[2] for s in shards]
    want = fk.temporal_reference_rdma(srcs, ends["plain"], plane_geoms, cfg, T, 1)
    got = fk.temporal_reference_rdma(srcs, ends["tiled"], plane_geoms, cfg, T, 1,
                                     tile=fk.FlatTile(rdma_plan["rows"], 24))
    for k in range(n):
        assert torch.equal(got[k], want[k]), k
        for a, b in zip(ends["tiled"][k][:3], ends["plain"][k][:3]):
            assert torch.equal(a, b), k


def test_launchers_on_the_cpu_lay_a_given_tile():
    """With tile_rows the CPU paths of both launchers write the blocked
    plain version at that tile, bitwise the chain's rows; a tile that
    leaves no output row is refused."""
    cfg, f, geoms = _scene(24, 40, np.float32)
    src, halo, geom = _shard(f, geoms["slip"], 2, 1, 3)
    want = fk.temporal_reference_ext(src, halo, geom, cfg, 3, row_offset=12)
    dst = torch.full_like(src, float("nan"))
    fk.ext_temporal_launcher(src, dst, halo, geom, cfg, 3, row0=2, rows=9, row_offset=12,
                             tile_rows=8)()
    assert torch.equal(dst[:, 2:11], want[:, 2:11]) and torch.isnan(dst[:, :2]).all()
    end = fk.rdma_end(cfg, "cpu", depth=3)
    out = torch.empty_like(f)
    fk.rdma_temporal_launcher(f, out, end, end, end, geoms["spec"], cfg, 3, card_shards=1,
                              tile_rows=7)(1)
    assert torch.equal(out, fk.temporal_reference(f, geoms["spec"], cfg, 3))
    for bad in (6, 0, 7.0, True):
        with pytest.raises(ValueError, match="tile_rows"):
            fk.ext_temporal_launcher(src, dst, halo, geom, cfg, 3, tile_rows=bad)
    with pytest.raises(ValueError, match="tile_rows"):
        fk.rdma_temporal_launcher(f, out, end, end, end, None, cfg, 3, card_shards=1, tile_rows=5)
