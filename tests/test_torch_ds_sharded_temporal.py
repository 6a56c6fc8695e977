"""The pair-DP shard pass on the CPU: passes of L pair steps on a shard
with Td-row pair halos, one halo exchange per pass.

csrc/lbm_ds_temporal_step.cu's ext-halo form runs a pass of L <= Td pair
steps on one shard of the row-sharded path, the rows beyond the shard from
two halo blocks of Td rows of each pair component and their class rows;
fused_ds_kernel.temporal_reference_ext (L chained step_reference calls on
the halo-extended block) is its plain version and
temporal_reference_ext_blocked its tiling in plain PyTorch (tiles laid
from the launch's first row, local row q < 0 read from the top halo's row
Td + q and q >= Ls from the bottom halo's row q - Ls, columns by modulo).
Here the tiling is held bitwise against the chain at every L a small tile
takes, both tiers, masked and wall-free, over whole shards, edge bands and
interiors; the chain on each shard of a ring bitwise against the local
pass over the whole lattice; ShardedDSSession's passes (n // 4 of 4, one
of the rest; both schedules) bitwise against fused_ds_kernel.run_steps on
CPU meshes of 1, 2 and 4 shards, and the one-step form where the
temporal form does not apply; the port's sharded path against the JAX
sharded-pallas-ds64-interpret (T=2; the JAX results are bitwise
independent of T); and the launcher's refusals. tests/test_torch_cuda.py
holds the kernel against both plain versions on a card. The bar is
bitwise throughout: the two sides run the same f32 ops in the same order.
"""

import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu import Simulation as JaxSimulation
from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.models import engine
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import df64
from latticeboltzmann_tpu_torch.ops import fused_ds_kernel as fdk
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
from latticeboltzmann_tpu_torch.ops.fused_kernel import ShardPlane
from latticeboltzmann_tpu_torch.parallel import sharded

torch.set_num_threads(1)

TIERS = {"fast": False, "exact": True}
# a small tile: output tiles of (9 - 2L) x (24 - 2 column_halo(L)) sites;
# it takes passes of up to 4 steps
SMALL_TILE = fk.FlatTile(9, 24)


def _scene(nx, ny, seed=0):
    """A perturbed float64 state split into a pair, with the forcing guard
    failing at one column-0 site, and a channel whose walls reach column
    0 across a shard boundary of 2 shards: (cfg, pair, solid plane)."""
    cfg = LatticeConfig(nx=nx, ny=ny, dtype=np.float64, accel=0.005)
    rng = np.random.default_rng(seed)
    f0 = initial_state(cfg) * (1 + 0.05 * rng.uniform(-1, 1, (9, nx, ny)))
    f0[6, nx // 2, 0] = 1e-6
    walls = geometry.channel(nx, ny)
    walls[nx // 2 - 1: nx // 2 + 1, 0:3] = True
    return cfg, df64.from_f64(f0), torch.as_tensor(walls.astype(np.uint8))


def _rows(x, a, b):
    """Rows [a, b) of x along dim -2, modulo its rows."""
    return x[..., [r % x.shape[-2] for r in range(a, b)], :].contiguous()


def _shard(f, solid, n, k, depth):
    """Shard k of a ring of n over the pair f: (its pair, its (top, bot)
    halo pairs of `depth` rows, its ShardPlane with (depth, NY) class
    rows)."""
    L = f.hi.shape[1] // n
    r0 = k * L
    pair = df64.DS(_rows(f.hi, r0, r0 + L), _rows(f.lo, r0, r0 + L))
    halo = tuple(df64.DS(_rows(f.hi, a, b), _rows(f.lo, a, b))
                 for a, b in ((r0 - depth, r0), (r0 + L, r0 + L + depth)))
    plane = ShardPlane(_rows(solid, r0, r0 + L), _rows(solid, r0 - depth, r0),
                       _rows(solid, r0 + L, r0 + L + depth))
    return pair, halo, plane


def _equal(a, b):
    return torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)


def _band(x, row0, rows):
    return df64.DS(x.hi[:, row0:row0 + rows], x.lo[:, row0:row0 + rows])


# ---- the plain versions ----

@pytest.mark.parametrize("walled", [True, False])
@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("shape", [(16, 36), (10, 8)])
def test_ext_blocked_equals_the_ext_chain(shape, tier, walled):
    """temporal_reference_ext_blocked at the small tile, Td = L, bitwise
    equal to temporal_reference_ext at every L it takes (1-4): over the
    whole shard, the two L-row edge bands (shorter than the tile's output
    rows at L <= 2) and the interior between them. At 16x36 (shards of 8
    rows) the last column of tiles holds column 0 in its right halo; at
    10x8 (shards of 5 rows) one tile is wider than the lattice and holds
    column 0 more than once. The walls reach column 0 and cross the shard
    boundary, and the guard fails at one fluid site."""
    cfg, f, solid = _scene(*shape)
    exact = TIERS[tier]
    for L in range(1, fk.tile_max_steps(SMALL_TILE, torch.float32) + 1):
        for k in range(2):
            pair, halo, plane = _shard(f, solid, 2, k, L)
            plane = plane if walled else None
            Ls = pair.hi.shape[1]
            want = fdk.temporal_reference_ext(pair.hi, pair.lo, halo, plane, cfg, exact, L)
            ranges = [(0, Ls), (0, L), (Ls - L, L)] + ([(L, Ls - 2 * L)] if Ls > 2 * L else [])
            for row0, rows in ranges:
                got = fdk.temporal_reference_ext_blocked(pair.hi, pair.lo, halo, plane, cfg,
                                                         exact, L, SMALL_TILE, row0, rows)
                assert _equal(got, _band(want, row0, rows)), (shape, L, k, row0, rows)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("tier", list(TIERS))
def test_ext_chain_on_each_shard_equals_the_local_pass(n, tier):
    """temporal_reference_ext on each shard of a ring of n, halos of
    DS_TEMPORAL rows from the ring neighbours (on one shard its own
    rows), bitwise equal to the shard's rows of the local
    temporal_reference over the whole lattice at every L up to 4."""
    cfg, f, solid = _scene(24, 40)
    exact = TIERS[tier]
    for L in range(1, fdk.DS_TEMPORAL + 1):
        want = fdk.temporal_reference(f.hi, f.lo, solid, cfg, exact, L)
        Ls = 24 // n
        for k in range(n):
            pair, halo, plane = _shard(f, solid, n, k, fdk.DS_TEMPORAL)
            got = fdk.temporal_reference_ext(pair.hi, pair.lo, halo, plane, cfg, exact, L)
            assert _equal(got, _band(want, k * Ls, Ls)), (L, k)


def test_plain_versions_refuse_reads_past_the_halos():
    cfg, f, solid = _scene(24, 36)
    pair, halo, plane = _shard(f, solid, 2, 0, 2)
    with pytest.raises(ValueError, match="halo"):
        fdk.temporal_reference_ext(pair.hi, pair.lo, halo, plane, cfg, False, 3)
    with pytest.raises(ValueError, match="past the 2-row halos"):
        fdk.temporal_reference_ext_blocked(pair.hi, pair.lo, halo, plane, cfg, False, 3,
                                           SMALL_TILE)
    with pytest.raises(ValueError, match="outside"):
        fdk.temporal_reference_ext_blocked(pair.hi, pair.lo, halo, plane, cfg, False, 2,
                                           SMALL_TILE, 10, 3)


# ---- the launcher on the CPU ----

def _dst(pair):
    return df64.DS(torch.full_like(pair.hi, float("nan")), torch.full_like(pair.lo, float("nan")))


def test_ext_temporal_launcher_on_the_cpu_writes_its_rows():
    """The CPU path of the launcher writes temporal_reference_ext's rows of
    its range and nothing else: an interior range needs no halo; the edge
    bands take it; no launch is counted."""
    cfg, f, solid = _scene(24, 40)
    pair, halo, plane = _shard(f, solid, 2, 1, 4)
    want = fdk.temporal_reference_ext(pair.hi, pair.lo, halo, plane, cfg, False, 3)
    before = (fdk.EXT_TEMPORAL_LAUNCHES, fdk.EXT_TEMPORAL_STEPS, fdk.EXT_LAUNCHES)
    dst = _dst(pair)
    fdk.ext_temporal_launcher(pair, dst, None, plane, cfg, 3, has_walls=True, row0=3, rows=6)()
    assert _equal(_band(dst, 3, 6), _band(want, 3, 6))
    assert torch.isnan(dst.hi[:, :3]).all() and torch.isnan(dst.lo[:, 9:]).all()
    for row0 in (0, 9):
        fdk.ext_temporal_launcher(pair, dst, halo, plane, cfg, 3, has_walls=True, row0=row0,
                                  rows=3)()
    assert _equal(dst, want)
    wall_free = fdk.temporal_reference_ext(pair.hi, pair.lo, halo, None, cfg, False, 3)
    fdk.ext_temporal_launcher(pair, dst, halo, None, cfg, 3, has_walls=False)()
    assert _equal(dst, wall_free)
    assert (fdk.EXT_TEMPORAL_LAUNCHES, fdk.EXT_TEMPORAL_STEPS, fdk.EXT_LAUNCHES) == before


def test_ext_temporal_launcher_refuses_what_the_form_does_not_take():
    """A pass deeper than the halos, a range that reads past the shard
    without them, NY of no whole 16-byte vectors, aliased buffers, a
    float32 config, halos of the wrong shape, a range outside the shard, a
    masked launch without a ShardPlane, a depth that is none: ValueError,
    never the one-step form instead."""
    cfg, f, solid = _scene(24, 40)
    pair, halo, plane = _shard(f, solid, 2, 0, 2)
    dst = _dst(pair)

    def launcher(*args, **kw):
        base = dict(src=pair, dst=dst, halo=halo, solid=plane, cfg=cfg, steps=2)
        base.update(kw)
        return fdk.ext_temporal_launcher(base.pop("src"), base.pop("dst"), base.pop("halo"),
                                         base.pop("solid"), base.pop("cfg"), base.pop("steps"),
                                         has_walls=True, **base)

    with pytest.raises(ValueError, match="halos hold 2"):
        launcher(steps=3)
    with pytest.raises(ValueError, match="give the halos"):
        launcher(halo=None, row0=1, rows=10)
    with pytest.raises(ValueError, match="four distinct"):
        launcher(dst=pair)
    with pytest.raises(ValueError, match="float64"):
        launcher(cfg=LatticeConfig(nx=24, ny=40))
    with pytest.raises(ValueError, match="halo blocks"):
        launcher(halo=(halo[0], df64.DS(halo[1].hi[:, :1].contiguous(), halo[1].lo[:, :1])))
    with pytest.raises(ValueError, match="outside"):
        launcher(row0=8, rows=6)
    with pytest.raises(ValueError, match="ShardPlane"):
        launcher(solid=plane.plane)
    for steps in (0, 2.0, True):
        with pytest.raises(ValueError, match="temporal"):
            launcher(steps=steps)
    cfg38, f38, solid38 = _scene(24, 38)
    pair38, halo38, plane38 = _shard(f38, solid38, 2, 0, 2)
    with pytest.raises(ValueError, match="multiple of 4"):
        fdk.ext_temporal_launcher(pair38, _dst(pair38), halo38, plane38, cfg38, 2,
                                  has_walls=True)


# ---- the session ----

def _record(monkeypatch):
    """Every call of an ext-halo launch from here on, in order: ("pass",
    steps, row0, rows) for the temporal form, ("step", 1, row0, rows) for
    the one-step form."""
    calls = []
    real_pass, real_step = fdk.ext_temporal_launcher, fdk.ext_launcher

    def recording_pass(src, dst, halo, solid, cfg, steps, **kw):
        call = real_pass(src, dst, halo, solid, cfg, steps, **kw)
        rows = kw.get("rows") or src.hi.shape[1] - kw.get("row0", 0)
        tag = ("pass", steps, kw.get("row0", 0), rows)
        return lambda: (calls.append(tag), call())

    def recording_step(src, dst, halo, solid, cfg, **kw):
        call = real_step(src, dst, halo, solid, cfg, **kw)
        rows = kw.get("rows") or src.hi.shape[1] - kw.get("row0", 0)
        tag = ("step", 1, kw.get("row0", 0), rows)
        return lambda: (calls.append(tag), call())

    monkeypatch.setattr(fdk, "ext_temporal_launcher", recording_pass)
    monkeypatch.setattr(fdk, "ext_launcher", recording_step)
    return calls


def _schedule(n, L, passes, overlap, form="pass"):
    """The launches a session of n shards of L rows makes for `passes`."""
    out = []
    for s in passes:
        for _ in range(n):
            if overlap and L >= 2 * s + 1:
                out += [(form, s, s, L - 2 * s), (form, s, 0, s), (form, s, L - s, s)]
            else:
                out.append((form, s, 0, L))
    return sorted(out)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_session_passes_equal_run_steps(n, overlap, monkeypatch):
    """ShardedDSSession(temporal=4) on a CPU mesh of n shards (48 rows:
    shards of 48, 24, 12), advance(7) then advance(6): passes of 4 and one
    of the rest (4, 3, then 4, 2), each pass one launch per shard, or with
    overlap the interior [s, L - s) and the two s-row bands; no one-step
    launch; the halos of 4 rows exchanged once per pass (4 copies a shard);
    bitwise equal to fused_ds_kernel.run_steps after each."""
    cfg, f, solid = _scene(48, 40)
    walls = solid.numpy() == 1
    sess = sharded.ShardedDSSession(cfg, walls, mesh=sharded.make_mesh(devices=["cpu"] * n),
                                    overlap=overlap)
    assert sess.temporal == fdk.DS_TEMPORAL
    calls = _record(monkeypatch)
    sess.load(f)
    done = 0
    for steps, passes in ((7, (4, 3)), (6, (4, 2))):
        del calls[:]
        before = sharded.HALO_COPIES
        sess.advance(steps)
        done += steps
        assert sorted(calls) == _schedule(n, 48 // n, passes, overlap)
        assert sharded.HALO_COPIES - before == len(passes) * 4 * n
        assert _equal(sess.state(), fdk.run_steps(f, walls, cfg, done))


@pytest.mark.parametrize("case", ["4-row shards", "3-row shards", "exact tier", "NY 38",
                                  "temporal=1"])
def test_session_runs_the_one_step_form_where_passes_do_not_apply(case, monkeypatch):
    """Shards of fewer than DS_TEMPORAL rows, the exact tier, an NY of no
    whole 16-byte vectors and temporal=1 run the one-step ext-halo form
    (a choice by shape or tier: the recorded launches are all one-step);
    4-row shards still take passes of 4. Bitwise equal to run_steps after
    6 steps."""
    nx, ny, n, kw = {"4-row shards": (16, 40, 4, {}), "3-row shards": (24, 40, 8, {}),
                     "exact tier": (16, 40, 2, {"exact": True}), "NY 38": (16, 38, 2, {}),
                     "temporal=1": (16, 40, 2, {"temporal": 1})}[case]
    cfg, f, solid = _scene(nx, ny)
    walls = solid.numpy() == 1
    sess = sharded.ShardedDSSession(cfg, walls, mesh=sharded.make_mesh(devices=["cpu"] * n),
                                    **kw)
    passes = case == "4-row shards"
    assert sess.temporal == (fdk.DS_TEMPORAL if passes else 1)
    calls = _record(monkeypatch)
    sess.load(f)
    sess.advance(6)
    L = nx // n
    want = (_schedule(n, L, (4, 2), False) if passes
            else _schedule(n, L, (1,) * 6, False, form="step"))
    assert sorted(calls) == want
    assert _equal(sess.unload(), fdk.run_steps(f, walls, cfg, 6, exact=kw.get("exact", False)))


@pytest.mark.parametrize("temporal", [0, fk.FLAT_MAX_TEMPORAL + 1, 2.5, True])
def test_session_refuses_a_depth_that_is_none(temporal):
    cfg, f, solid = _scene(16, 40)
    with pytest.raises(ValueError, match="temporal"):
        sharded.ShardedDSSession(cfg, solid.numpy() == 1,
                                 mesh=sharded.make_mesh(devices=["cpu"] * 2), temporal=temporal)


def test_facade_probed_run_ends_passes_at_samples(monkeypatch):
    """Simulation(backend="sharded-cuda-ds64") over 2 CPU shards:
    run_probed(6, every=3) runs a pass of 3 per sample (no pass crosses a
    sample), run(5) passes of 4 and 1, each one launch per shard (the
    backend's default schedule, overlap=False); the series and the state
    bitwise equal to cuda-ds64's (the local passes' plain version)."""
    monkeypatch.setattr(engine, "_KERNEL_BACKENDS", set())
    monkeypatch.setitem(engine._BACKENDS, "sharded-cuda-ds64",
                        sharded.make_cuda_ds_backend(sharded.make_mesh(devices=["cpu"] * 2)))
    cfg, f, solid = _scene(16, 40)
    walls = solid.numpy() == 1
    f0 = df64.to_f64(f)
    probes = [(3, 0), (8, 20), (15, 39)]
    calls = _record(monkeypatch)
    sims = {b: Simulation(cfg, walls, backend=b, device="cpu", f0=f0)
            for b in ("sharded-cuda-ds64", "cuda-ds64")}
    series = {b: s.run_probed(6, probes, every=3) for b, s in sims.items()}
    assert sorted(calls) == _schedule(2, 8, (3, 3), False)
    np.testing.assert_array_equal(series["sharded-cuda-ds64"], series["cuda-ds64"])
    del calls[:]
    for s in sims.values():
        s.run(5)
    assert sorted(calls) == _schedule(2, 8, (4, 1), False)
    np.testing.assert_array_equal(sims["sharded-cuda-ds64"].state(), sims["cuda-ds64"].state())


# ---- against the JAX runner ----

def test_sharded_passes_equal_jax_sharded_interpret():
    """The port's sharded path in passes of 4 (4 CPU shards of 16 rows, 10
    steps: passes of 4, 4 and 2, one launch per shard) against the JAX
    sharded-pallas-ds64-interpret over conftest's 8 virtual devices (T=2,
    5 passes), tests/test_torch_probes.py's 64x40 scene; bitwise."""
    walls = geometry.channel(64, 40)
    walls[20:30, 10:13] = True
    rng = np.random.default_rng(1)
    cfg = LatticeConfig(nx=64, ny=40, dtype=np.float64)
    f0 = initial_state(cfg) * (1 + 0.05 * rng.uniform(-1, 1, (9, 64, 40)))
    run = sharded.make_cuda_ds_run_steps(sharded.make_mesh(devices=["cpu"] * 4), cfg)
    got = df64.to_f64(run(df64.from_f64(f0), torch.as_tensor(walls), 10))
    jsim = JaxSimulation(JaxConfig(nx=64, ny=40, dtype=np.float64), walls,
                         backend="sharded-pallas-ds64-interpret", f0=f0)
    np.testing.assert_array_equal(got, np.asarray(jsim.run(10).state()))
