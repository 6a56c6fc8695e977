"""The pair-DP path's temporal blocking on the CPU: passes of L pair steps.

csrc/lbm_ds_temporal_step.cu runs a pass of L pair-DP steps from one
(hi, lo) pair to the other in a tile of shared memory, a class byte per
tile site; fused_ds_kernel.temporal_reference (L chained step_reference
calls) is its plain version and temporal_reference_blocked its tiling in
plain PyTorch (tiles, halos and classes by modulo, levels that shrink by
one site, the pair forcing at fluid sources of global column 0 with the
guard read at the level being read, bounce-back). Here the tiling is held
bitwise against the chain at both tiers, masked and wall-free, at every L
a small tile takes; the Session's passes (n // T of T steps, one of the
rest) bitwise against one step per launch; run_steps at temporal=4
bitwise against the JAX fused ds kernel in interpret mode
(tests/test_ds.py:213-229's program; T=2 there, since interpret compiles
at T >= 3 take minutes, and the JAX kernel's results are bitwise
independent of T); the cuda-ds64 facade's passes of 4; and the wrapper's
and the session's refusals. tests/test_torch_cuda.py holds the kernel
against both plain versions on a card. The bar is bitwise throughout: the
two sides run the same f32 ops in the same order.
"""

import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu import geometry as jgeo
from latticeboltzmann_tpu.models import golden
from latticeboltzmann_tpu.ops import df64 as jdf
from latticeboltzmann_tpu.ops import fused_ds_kernel as jfdk
from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.models import engine
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import df64
from latticeboltzmann_tpu_torch.ops import fused_ds_kernel as fdk
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk

torch.set_num_threads(1)

TIERS = {"fast": False, "exact": True}
# a small tile: output tiles of (9 - 2L) x (24 - 2 column_halo(L)) sites,
# several to a lattice; it takes passes of up to 4 steps
SMALL_TILE = fk.FlatTile(9, 24)


def _scene(nx, ny, seed=0):
    """A perturbed float64 state split into a pair, with the forcing guard
    failing at one column-0 site, and a channel whose walls reach column
    0: (cfg, pair, solid plane)."""
    cfg = LatticeConfig(nx=nx, ny=ny, dtype=np.float64, accel=0.005)
    rng = np.random.default_rng(seed)
    f0 = initial_state(cfg) * (1 + 0.05 * rng.uniform(-1, 1, (9, nx, ny)))
    f0[6, nx // 2, 0] = 1e-6
    walls = geometry.channel(nx, ny)
    walls[nx // 3: nx // 3 + 2, 0:3] = True
    return cfg, df64.from_f64(f0), torch.as_tensor(walls.astype(np.uint8))


def _equal(a, b):
    return torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)


# ---- the tiling ----

def test_small_tile_takes_four_steps_and_refuses_five():
    assert fk.tile_max_steps(SMALL_TILE, torch.float32) == 4
    cfg, f, solid = _scene(13, 36)
    with pytest.raises(ValueError, match="no output tile"):
        fdk.temporal_reference_blocked(f.hi, f.lo, solid, cfg, False, 5, SMALL_TILE)


@pytest.mark.parametrize("walled", [True, False])
@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("shape", [(13, 36), (5, 8)])
def test_blocked_equals_chained_steps(shape, tier, walled):
    """temporal_reference_blocked at the small tile, bitwise equal to L
    chained step_reference calls at every L it takes (1-4). At 13x36 the
    tiles are ragged in both axes (output tiles of up to 7 x 16 sites) and
    column 0 lies in the right halo of the last column of tiles; at 5x8
    one tile is larger than the lattice and holds column 0 more than once.
    The walls reach column 0, and the guard fails at one fluid site."""
    cfg, f, solid = _scene(*shape)
    solid = solid if walled else None
    exact = TIERS[tier]
    chained = f
    for steps in range(1, fk.tile_max_steps(SMALL_TILE, torch.float32) + 1):
        chained = fdk.step_reference(chained.hi, chained.lo, solid, cfg, exact)
        assert _equal(fdk.temporal_reference(f.hi, f.lo, solid, cfg, exact, steps), chained)
        got = fdk.temporal_reference_blocked(f.hi, f.lo, solid, cfg, exact, steps, SMALL_TILE)
        assert _equal(got, chained), (shape, steps)


def test_blocked_at_the_cards_tile():
    """The H100's tile of two CTAs an SM (22 x 72 sites: one tile wider
    than a 16x40 lattice, sites repeated by the wrap) at L = 2."""
    cfg, f, solid = _scene(16, 40)
    want = fdk.temporal_reference(f.hi, f.lo, solid, cfg, False, 2)
    assert _equal(fdk.temporal_reference_blocked(f.hi, f.lo, solid, cfg, False, 2,
                                                 fk.FlatTile(22, 72)), want)


# ---- the session's passes ----

def _record_passes(monkeypatch):
    """The steps of every temporal_step call from here on, in order, and 0
    for every call of the one-step wrapper."""
    passes = []
    real_pass, real_step = fdk.temporal_step, fdk.step

    def recording_pass(src, dst, solid, cfg, steps, **kw):
        passes.append(steps)
        return real_pass(src, dst, solid, cfg, steps, **kw)

    def recording_step(*args, **kw):
        passes.append(0)
        return real_step(*args, **kw)

    monkeypatch.setattr(fdk, "temporal_step", recording_pass)
    monkeypatch.setattr(fdk, "step", recording_step)
    return passes


@pytest.mark.parametrize("temporal", [2, 4])
@pytest.mark.parametrize("tier", list(TIERS))
def test_session_passes_equal_one_step_per_launch(tier, temporal, monkeypatch):
    """Session(temporal=T) at n = 7 and then 6 more steps: at the fast
    tier passes of T and one of n % T with no one-step launch, at the
    exact tier one step per launch (a choice by tier); bitwise equal to a
    session of one launch per step."""
    cfg, f, solid = _scene(16, 40)
    walls = solid.numpy() == 1
    one = fdk.Session(cfg, walls, device="cpu", exact=TIERS[tier], temporal=1)
    sess = fdk.Session(cfg, walls, device="cpu", exact=TIERS[tier], temporal=temporal)
    temporal = 1 if TIERS[tier] else temporal
    assert (one.temporal, sess.temporal) == (1, temporal)
    one.load(f)
    sess.load(f)
    passes = _record_passes(monkeypatch)
    for n in (7, 6):
        one.advance(n)
        assert passes == [0] * n
        del passes[:]
        sess.advance(n)
        want = [temporal] * (n // temporal) + ([n % temporal] if n % temporal else [])
        assert passes == ([0] * n if temporal == 1 else want)
        del passes[:]
        assert _equal(sess.state(), one.state())


def test_session_defaults_to_passes_of_ds_temporal_where_the_shape_allows():
    """The default depth is the JAX kernel's DS_TEMPORAL; an NY of no whole
    16-byte vectors runs the one-step kernel at any depth, a choice by
    shape."""
    assert fdk.DS_TEMPORAL == jfdk.DS_TEMPORAL == 4
    for ny, depth in ((40, 4), (38, 1), (37, 1)):
        cfg = LatticeConfig(nx=8, ny=ny, dtype=np.float64)
        assert fdk.Session(cfg, geometry.channel(8, ny), device="cpu").temporal == depth, ny
    cfg = LatticeConfig(nx=8, ny=40, dtype=np.float64)
    assert fdk.Session(cfg, geometry.channel(8, 40), device="cpu", temporal=1).temporal == 1


def test_run_steps_at_temporal_4_equals_jax_kernel():
    """The port's run_steps at its default temporal=4 (5 passes of 4)
    against the JAX fused ds kernel in interpret mode at temporal=2,
    tests/test_ds.py:213-229's program: 32x96, 20 steps from a perturbed
    state, the fast tier; bitwise."""
    jcfg = JaxConfig(nx=32, ny=96, dtype=np.float64)
    walls = jgeo.channel_with_barrier(32, 96, barrier_rows=(5, 9), barrier_cols=(10, 13))
    rng = np.random.default_rng(0)
    f = golden.initial_state(jcfg)
    f0 = f * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, f.shape))
    want = jdf.to_f64(jfdk.run_steps(jdf.from_f64(f0), np.asarray(walls), jcfg, 20,
                                     interpret=True, temporal=2))
    cfg = LatticeConfig(nx=32, ny=96, dtype=np.float64)
    got = fdk.run_steps(df64.from_f64(f0), torch.as_tensor(walls), cfg, 20)
    np.testing.assert_array_equal(df64.to_f64(got), want)


# ---- the facade ----

@pytest.fixture
def cuda_on_cpu(monkeypatch):
    """The kernel backends' sessions on the CPU (their plain versions), for
    the test."""
    monkeypatch.setattr(engine, "_KERNEL_BACKENDS", set())


def test_cuda_ds64_runs_passes_of_four(cuda_on_cpu, monkeypatch):
    """Simulation(backend="cuda-ds64") reaches the temporal session: run(5)
    + run(7) in passes of 4 and one of the rest, bitwise equal to one step
    per launch; run_probed's samples fall on pass boundaries (every = 3:
    a pass of 3 each); at NY 38 every step is a one-step launch."""
    cfg, f, solid = _scene(16, 40)
    walls = solid.numpy() == 1
    f0 = df64.to_f64(f)
    sim = Simulation(cfg, walls, backend="cuda-ds64", device="cpu", f0=f0)
    assert sim._session.temporal == fdk.DS_TEMPORAL
    passes = _record_passes(monkeypatch)
    sim.run(5).run(7)
    assert passes == [4, 1, 4, 3]
    one = fdk.Session(cfg, walls, device="cpu", temporal=1)
    one.load(df64.from_f64(f0))
    del passes[:]
    one.advance(12)
    np.testing.assert_array_equal(sim.state(), df64.to_f64(one.state()))
    probes = [(5, 20), (12, 3)]
    del passes[:]
    series = sim.run_probed(6, probes, every=3)
    assert passes == [3, 3] and series.shape == (2, 2, 3)
    cfg38 = LatticeConfig(nx=16, ny=38, dtype=np.float64)
    del passes[:]
    Simulation(cfg38, geometry.channel(16, 38), backend="cuda-ds64", device="cpu").run(3)
    assert passes == [0, 0, 0]


# ---- refusals ----

def _buffers(cfg, f):
    return df64.DS(torch.empty_like(f.hi), torch.empty_like(f.lo))


@pytest.mark.parametrize("steps", [0, fk.FLAT_MAX_TEMPORAL + 1, 2.0, True])
def test_temporal_step_refuses_a_depth_that_is_none(steps):
    cfg, f, solid = _scene(16, 40)
    before = (fdk.TEMPORAL_LAUNCHES, fdk.TEMPORAL_STEPS)
    with pytest.raises(ValueError, match="temporal"):
        fdk.temporal_step(f, _buffers(cfg, f), solid, cfg, steps, has_walls=True)
    with pytest.raises(ValueError, match="temporal"):
        fdk.Session(cfg, solid.numpy() == 1, device="cpu", temporal=steps)
    assert (fdk.TEMPORAL_LAUNCHES, fdk.TEMPORAL_STEPS) == before


def test_temporal_step_refuses_what_the_form_does_not_take():
    """NY of no whole 16-byte vectors, aliased buffers, an f32 config, a
    missing solid plane: ValueError, never one step per launch instead."""
    cfg38, f38, solid38 = _scene(16, 38)
    with pytest.raises(ValueError, match="multiple of 4"):
        fdk.temporal_step(f38, _buffers(cfg38, f38), solid38, cfg38, 2, has_walls=True)
    cfg, f, solid = _scene(16, 40)
    with pytest.raises(ValueError, match="four distinct buffers"):
        fdk.temporal_step(f, f, solid, cfg, 2, has_walls=True)
    with pytest.raises(ValueError, match="float64"):
        fdk.temporal_step(f, _buffers(cfg, f), solid, LatticeConfig(nx=16, ny=40), 2,
                          has_walls=True)
    with pytest.raises(ValueError):
        fdk.temporal_step(f, _buffers(cfg, f), None, cfg, 2, has_walls=True)


def test_temporal_step_on_the_cpu_writes_the_chain():
    """The CPU wrapper path writes temporal_reference's pair into dst and
    counts no launch."""
    cfg, f, solid = _scene(16, 40)
    before = (fdk.TEMPORAL_LAUNCHES, fdk.TEMPORAL_STEPS, fdk.LAUNCHES)
    for walled in (True, False):
        dst = fdk.temporal_step(f, _buffers(cfg, f), solid if walled else None, cfg, 3,
                                has_walls=walled)
        want = fdk.temporal_reference(f.hi, f.lo, solid if walled else None, cfg, False, 3)
        assert _equal(dst, want)
    assert (fdk.TEMPORAL_LAUNCHES, fdk.TEMPORAL_STEPS, fdk.LAUNCHES) == before
    meta = df64.DS(f.hi.to("meta"), f.lo.to("meta"))
    with pytest.raises(RuntimeError):
        fdk.temporal_step(meta, _buffers(cfg, meta), None, cfg, 2, has_walls=False)
