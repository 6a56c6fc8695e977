"""The main path's temporal blocking on the CPU: passes of L steps.

csrc/lbm_temporal_step.cu runs a pass of L steps with walls from one
buffer to the other in the flat kernel's tile, a solid class per tile
site; fused_kernel.temporal_reference (L chained step_reference calls) is
its plain version and temporal_reference_blocked its tiling in plain
PyTorch (tiles, halos and classes by modulo, levels that shrink by one
site, forcing at fluid sources of global column 0, each level site's
class). Here the tiling is held bitwise against the chain for float32
and bf16, every geometry source and L = 1-4, on tiles forced small; the
Session's passes (n // T of T steps, one of the rest) bitwise against one
step per launch; the default depth's rule (default_temporal) and the
session's use of it on a card and on the CPU; the Session against the
JAX fused kernel at temporal=T
in interpret mode at the bars of the JAX package's own tests
(tests/test_pallas.py:112-138, 234-246); at an NY of no whole 16-byte
vectors the session's choice of one step per launch, bitwise to
temporal=None and held against the JAX kernel's passes there; and the
facade's and the wrapper's refusals. tests/test_torch_cuda.py holds the kernel against
both plain versions on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu import geometry as jgeo
from latticeboltzmann_tpu.models.engine import initial_state as jax_initial_state
from latticeboltzmann_tpu.ops import fused_kernel as jfk
from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.models import engine
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
from latticeboltzmann_tpu_torch.parallel import sharded
from latticeboltzmann_tpu_torch.utils.interop import state_tensor

torch.set_num_threads(1)

DTYPES = [np.float32, "bfloat16"]
GEOMS = ["none", "plane", "spec", "slip"]


def _scene(nx, ny, dtype, seed=0):
    """A perturbed state, with the forcing guard failing at one column-0
    site, and every geometry source of a channel whose walls reach column
    0: (cfg, state, {kind: geom})."""
    cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype, accel=0.005)
    rng = np.random.default_rng(seed)
    f0 = initial_state(cfg) * (1 + 0.05 * rng.uniform(-1, 1, (9, nx, ny)))
    f0[6, nx // 2, 0] = 1e-6
    walls = geometry.channel(nx, ny)
    walls[nx // 3: nx // 3 + 3, 0:3] = True
    slip_x = np.zeros_like(walls)
    slip_x[0] = True
    open_top = walls.copy()
    open_top[0] = False
    slip_y = np.zeros_like(walls)
    slip_y[nx // 2, 5:7] = True
    spec = (("channel",), ("rect", nx // 3, nx // 3 + 3, 0, 3))
    assert np.array_equal(geometry.spec_mask(spec, nx, ny), walls)
    geoms = {"none": None, "plane": torch.as_tensor(walls.astype(np.uint8)), "spec": spec,
             "slip": torch.as_tensor(fk.class_plane(open_top, slip_x, slip_y))}
    return cfg, state_tensor(f0.astype(np.float32), cfg.dtype, "cpu"), geoms


def _small_tile(dtype, steps):
    """The smallest tile that leaves an output site at `steps` steps, and
    one more vector of columns: many tiles on a small lattice."""
    v = fk.WIDE_COLUMNS[dtype]
    return fk.FlatTile(2 * steps + 3, 2 * (-(-steps // v) * v) + 2 * v)


# ---- the tiling ----

@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_blocked_equals_chained_steps(dtype, geom):
    """temporal_reference_blocked bitwise equal to L chained step_reference
    calls at L = 1-4: small tiles (several tiles, a ragged last row and
    column), the card's tile (one tile larger than the lattice, sites
    repeated by the wrap), and a 5x8 lattice smaller than either; the
    walls and the slip block reach column 0, where the guard fails at one
    fluid site."""
    for nx, ny in ((16, 40), (24, 40), (5, 8)):
        cfg, t, geoms = _scene(nx, ny, dtype)
        card = fk.FlatTile(43 if t.dtype == torch.float32 else 84, 72)
        for steps in (1, 2, 3, 4):
            want = fk.temporal_reference(t, geoms[geom], cfg, steps)
            chained = t
            for _ in range(steps):
                chained = fk.step_reference(chained, None if geom == "spec" else geoms[geom], cfg,
                                            wall_spec=geoms[geom] if geom == "spec" else None)
            assert torch.equal(want, chained)
            for tile in (_small_tile(t.dtype, steps), card):
                got = fk.temporal_reference_blocked(t, geoms[geom], cfg, steps, tile)
                assert got.dtype == t.dtype and torch.equal(got, want), (nx, ny, steps, tile)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_max_steps_is_the_deepest_pass_with_an_output(dtype):
    """The card's tiles of an H100 (43 rows in float32, 84 in bf16, 72
    columns) take 21 and 32 steps a pass; one more leaves no output site,
    and the blocked plain version refuses it."""
    tile = fk.FlatTile(43, 72) if dtype == np.float32 else fk.FlatTile(84, 72)
    st = torch.float32 if dtype == np.float32 else torch.bfloat16
    most = fk.tile_max_steps(tile, st)
    assert most == (21 if dtype == np.float32 else 32)
    assert min(fk.flat_output(tile, st, most)) >= 1
    assert most == fk.FLAT_MAX_TEMPORAL or min(fk.flat_output(tile, st, most + 1)) < 1
    assert fk.tile_max_steps(fk.FlatTile(2, 72), st) == 0
    cfg, t, _ = _scene(16, 40, dtype)
    with pytest.raises(ValueError, match="no output tile"):
        fk.temporal_reference_blocked(t, None, cfg, 3, fk.FlatTile(6, 72))


# ---- the session's passes ----

def _record_passes(monkeypatch):
    """The steps of every temporal_step call from here on, in order, and 0
    for every call of the one-step wrapper."""
    passes = []
    real_pass, real_step = fk.temporal_step, fk.step

    def recording_pass(src, dst, geom, cfg, steps, **kw):
        passes.append(steps)
        return real_pass(src, dst, geom, cfg, steps, **kw)

    def recording_step(*args, **kw):
        passes.append(0)
        return real_step(*args, **kw)

    monkeypatch.setattr(fk, "temporal_step", recording_pass)
    monkeypatch.setattr(fk, "step", recording_step)
    return passes


def _session_geometry(geom, g):
    """(walls, Session keywords) of _scene's 16x40 geometry `g` of kind
    `geom`."""
    if geom == "spec":
        return geometry.spec_mask(g, 16, 40), {"wall_spec": g}
    if geom == "none":
        return np.zeros((16, 40), bool), {}
    walls = g.numpy() == 1
    return walls, ({"slip_x": g.numpy() == 2, "slip_y": g.numpy() == 3} if geom == "slip" else {})


@pytest.mark.parametrize("temporal", [2, 3, 5])
@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_session_passes_equal_one_step_per_launch(dtype, geom, temporal, monkeypatch):
    """Session(temporal=T) at n = 7 and then 12 more steps: passes of T
    steps and one of n % T, bitwise equal to a session of one launch per
    step, with no one-step launch."""
    cfg, t, geoms = _scene(16, 40, dtype)
    walls, kw = _session_geometry(geom, geoms[geom])
    one = fk.Session(cfg, walls, device="cpu", **kw)
    sess = fk.Session(cfg, walls, device="cpu", temporal=temporal, **kw)
    assert one.temporal == 1 and sess.temporal == temporal
    one.load(t)
    sess.load(t)
    passes = _record_passes(monkeypatch)
    for n in (7, 12):
        one.advance(n)
        assert passes == [0] * n
        del passes[:]
        sess.advance(n)
        assert passes == [temporal] * (n // temporal) + ([n % temporal] if n % temporal else [])
        del passes[:]
        assert torch.equal(sess.state(), one.state())


# the rows the temporal form takes (whole 16-byte vectors) and not, by storage
DEFAULT_ROWS = {torch.float32: (40, 37), torch.bfloat16: (48, 44)}


@pytest.mark.parametrize("device_type, max_steps, want", [
    ("cpu", 21, 1), ("cuda", 21, 6), ("cuda", 32, 6), ("cuda", 4, 4), ("cuda", 1, 1),
    ("cuda", 0, 1)])
@pytest.mark.parametrize("whole", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_default_temporal_rule(dtype, whole, device_type, max_steps, want):
    """The depth Session(temporal=None) runs: DEFAULT_TEMPORAL (6) on a
    card where the temporal form takes the rows, no deeper than the card's
    tile takes (the H100's 21 and 32 steps, a tile of 4, one that takes 1
    or none); one step a launch on the CPU and at an NY of no whole
    16-byte vectors."""
    assert fk.DEFAULT_TEMPORAL[dtype] == 6
    ny = DEFAULT_ROWS[dtype][0 if whole else 1]
    assert fk.temporal_form_takes(dtype, ny) is whole
    got = fk.default_temporal(dtype, ny, device_type, max_steps)
    assert got == (want if whole else 1)


@pytest.mark.parametrize("max_steps", [21, 4, 0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_session_on_a_card_runs_the_default_depth(dtype, max_steps, monkeypatch):
    """Session(device="cuda", temporal=None) as the card describes its
    tile (temporal_info's max_steps; nothing is allocated before load):
    default_temporal's depth where the rows are whole vectors, 1 where
    they are not; requested_temporal stays None. An explicit depth is the
    session's own there, as before."""
    info = {"max_steps": max_steps, "rows": 2 * max_steps + 1, "width": 72}
    monkeypatch.setattr(fk, "temporal_info", lambda dtype, *a, **kw: info)
    st = fk._storage(LatticeConfig(nx=16, ny=40, dtype=dtype))
    for ny, want in ((DEFAULT_ROWS[st][0], max(1, min(6, max_steps))), (DEFAULT_ROWS[st][1], 1)):
        cfg = LatticeConfig(nx=16, ny=ny, dtype=dtype)
        spec = (("channel",),)
        walls = geometry.spec_mask(spec, 16, ny)
        sess = fk.Session(cfg, walls, device="cuda", wall_spec=spec)
        assert (sess.temporal, sess.requested_temporal) == (want, None)
        if max_steps >= 3:
            sess = fk.Session(cfg, walls, device="cuda", wall_spec=spec, temporal=3)
            takes = fk.temporal_form_takes(st, ny)
            assert (sess.temporal, sess.requested_temporal) == (3 if takes else 1, 3)
        else:
            with pytest.raises(ValueError, match="at most"):
                fk.Session(cfg, walls, device="cuda", wall_spec=spec, temporal=3)
        sess = fk.Session(cfg, walls, device="cuda", wall_spec=spec, temporal=1)
        assert (sess.temporal, sess.requested_temporal) == (1, 1)


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_session_on_the_cpu_runs_one_step_per_launch_by_default(dtype, geom, monkeypatch):
    """Session(device="cpu") with no depth runs one launch of the one-step
    wrapper per step (a pass there is temporal_reference, a plain
    emulation), bitwise equal to temporal=1 and to temporal=6's passes."""
    cfg, t, geoms = _scene(16, 40, dtype)
    walls, kw = _session_geometry(geom, geoms[geom])
    sessions = [fk.Session(cfg, walls, device="cpu", temporal=t_, **kw) for t_ in (None, 1, 6)]
    assert [(s.temporal, s.requested_temporal) for s in sessions] == [(1, None), (1, 1), (6, 6)]
    passes = _record_passes(monkeypatch)
    for sess, want in zip(sessions, ([0] * 8, [0] * 8, [6, 2])):
        sess.load(t)
        sess.advance(8)
        assert passes == want
        passes.clear()
    assert torch.equal(sessions[0].state(), sessions[1].state())
    assert torch.equal(sessions[0].state(), sessions[2].state())


@pytest.mark.parametrize("n, default_plan, asked_plan", [
    (1, [0], [1]), (7, [6, 0], [6, 1]), (13, [6, 6, 0], [6, 6, 1]), (14, [6, 6, 2], [6, 6, 2]),
    (12, [6, 6], [6, 6])])
@pytest.mark.parametrize("dtype", DTYPES)
def test_default_depth_runs_a_pass_of_one_step_as_one_step(dtype, n, default_plan, asked_plan,
                                                           monkeypatch):
    """At the default depth (default_temporal's 6, as on a card) a pass of
    one step, an advance of 1 or a rest of 1, is a launch of the one-step
    wrapper (0 in the plan); an asked temporal=6 runs it as a pass of 1.
    Both count one launch a pass and equal temporal=1 bitwise."""
    monkeypatch.setattr(fk, "default_temporal", lambda *a: 6)
    cfg, t, geoms = _scene(16, 40, dtype)
    walls, kw = _session_geometry("spec", geoms["spec"])
    sessions = [fk.Session(cfg, walls, device="cpu", temporal=t_, **kw) for t_ in (None, 6, 1)]
    assert [(s.temporal, s.requested_temporal) for s in sessions] == [(6, None), (6, 6), (1, 1)]
    passes = _record_passes(monkeypatch)
    for sess, want in zip(sessions, (default_plan, asked_plan, [0] * n)):
        sess.load(t)
        sess.advance(n)
        assert passes == want and (sess.launches, sess.steps) == (len(want), n)
        passes.clear()
    assert torch.equal(sessions[0].state(), sessions[2].state())
    assert torch.equal(sessions[1].state(), sessions[2].state())


def test_run_steps_and_probed_runner_take_temporal(monkeypatch):
    """fused_kernel.run_steps and run_steps_probed at temporal=3 equal
    temporal=None bitwise; the probed runner's every = 4 steps are one
    advance each: a pass of 3 and one of 1."""
    cfg, t, geoms = _scene(16, 40, np.float32)
    walls = geoms["plane"].numpy() == 1
    want = fk.run_steps(t, walls, cfg, 10)
    assert torch.equal(fk.run_steps(t, walls, cfg, 10, temporal=3), want)
    probes = [(5, 10), (8, 30)]
    f1, s1 = fk.run_steps_probed(t, walls, cfg, 12, probes, every=4)
    passes = _record_passes(monkeypatch)
    f3, s3 = fk.run_steps_probed(t, walls, cfg, 12, probes, every=4, temporal=3)
    assert passes == [3, 1] * 3
    assert torch.equal(f3, f1) and torch.equal(s3, s1)


# ---- the facade ----

@pytest.fixture
def cuda_on_cpu(monkeypatch):
    """The cuda backend's session on the CPU (its plain versions), for the
    test."""
    monkeypatch.setattr(engine, "_KERNEL_BACKENDS", set())


@pytest.mark.parametrize("dtype", DTYPES)
def test_simulation_temporal_on_cuda_is_bitwise_and_runs_passes(dtype, cuda_on_cpu, monkeypatch):
    """Simulation(backend="cuda", temporal=T) hands T to its session: run
    in passes, and run(a) + run(b) with a no multiple of T equal to run(a +
    b) and to temporal=None; run_probed at every = 1, 3 and 4 equal to
    temporal=None's series, its state too."""
    cfg = LatticeConfig(nx=16, ny=40, dtype=dtype)
    walls = geometry.channel(16, 40)
    walls[5:9, 10:13] = True
    ref = Simulation(cfg, walls, backend="cuda", device="cpu").run(12)
    sim = Simulation(cfg, walls, backend="cuda", device="cpu", temporal=3)
    assert sim.temporal == 3 and sim._session.temporal == 3
    passes = _record_passes(monkeypatch)
    sim.run(5).run(7)
    assert passes == [3, 2, 3, 3, 1]  # no one-step launch
    np.testing.assert_array_equal(sim.state(), ref.state())
    probes = [(5, 20), (12, 3)]
    for every in (1, 3, 4):
        a = Simulation(cfg, walls, backend="cuda", device="cpu")
        b = Simulation(cfg, walls, backend="cuda", device="cpu", temporal=3)
        np.testing.assert_array_equal(b.run_probed(12, probes, every=every),
                                      a.run_probed(12, probes, every=every))
        np.testing.assert_array_equal(b.state(), a.state())


@pytest.mark.parametrize("backend", ["torch", "cuda", "sharded"])
@pytest.mark.parametrize("temporal", [0, -1, 2.5, True, "2"])
def test_simulation_refuses_a_temporal_that_is_no_depth(temporal, backend, cuda_on_cpu):
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    with pytest.raises(ValueError, match="temporal"):
        Simulation(cfg, geometry.channel(16, 40), backend=backend, device="cpu",
                   temporal=temporal)


@pytest.mark.parametrize("backend", ["torch", "sharded"])
def test_temporal_selects_nothing_on_the_other_backends(backend, monkeypatch):
    """On torch and sharded, temporal is kept as given and the state is
    the same, as the JAX facade passes it only to pallas; no pass of the
    temporal form runs."""
    monkeypatch.setitem(engine._BACKENDS, "sharded",
                        sharded.make_backend(sharded.make_mesh(devices=["cpu"] * 2)))
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    walls = geometry.channel(16, 40)
    walls[5:9, 10:13] = True
    passes = _record_passes(monkeypatch)
    want = Simulation(cfg, walls, backend=backend, device="cpu").run(7).state()
    sim = Simulation(cfg, walls, backend=backend, device="cpu", temporal=4)
    assert sim.temporal == 4
    np.testing.assert_array_equal(sim.run(7).state(), want)
    assert passes == []


def test_session_refuses_what_the_temporal_form_does_not_take(cuda_on_cpu):
    """A depth past FLAT_MAX_TEMPORAL or no integer: ValueError when the
    session is built, at any shape. A row of no whole 16-byte vectors (NY
    37 in float32, 44 in bf16) is refused by temporal_step alone: there
    Session(temporal=2) and Simulation(backend="cuda", temporal=2) choose
    one step per launch by shape (the session's temporal 1, its
    requested_temporal 2), as temporal=1 and None do on any shape."""
    for ny, dtype in ((37, np.float32), (44, "bfloat16")):
        cfg = LatticeConfig(nx=16, ny=ny, dtype=dtype)
        walls = geometry.channel(16, ny)
        sess = fk.Session(cfg, walls, device="cpu", temporal=2)
        assert (sess.temporal, sess.requested_temporal) == (1, 2)
        sim = Simulation(cfg, walls, backend="cuda", device="cpu", temporal=2)
        assert sim.temporal == 2 and sim._session.temporal == 1
        for temporal in (None, 1):
            assert fk.Session(cfg, walls, device="cpu", temporal=temporal).temporal == 1
        for temporal in (0, fk.FLAT_MAX_TEMPORAL + 1, 2.0, True):
            with pytest.raises(ValueError):
                fk.Session(cfg, walls, device="cpu", temporal=temporal)
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    walls = geometry.channel(16, 40)
    for temporal in (0, fk.FLAT_MAX_TEMPORAL + 1, 2.0, True):
        with pytest.raises(ValueError):
            fk.Session(cfg, walls, device="cpu", temporal=temporal)
    t = state_tensor(initial_state(cfg), cfg.dtype, "cpu")
    with pytest.raises(ValueError):
        fk.temporal_step(t, torch.empty_like(t), None, cfg, 0)
    with pytest.raises(ValueError, match="out of place"):
        fk.temporal_step(t, t, None, cfg, 2)
    cfg37 = LatticeConfig(nx=16, ny=37, dtype=np.float32)
    t37 = state_tensor(initial_state(cfg37), cfg37.dtype, "cpu")
    with pytest.raises(ValueError, match="multiple of"):
        fk.temporal_step(t37, torch.empty_like(t37), None, cfg37, 2)


@pytest.mark.parametrize("temporal", [2, 3])
@pytest.mark.parametrize("ny, dtype", [(37, np.float32), (44, "bfloat16")])
def test_temporal_at_an_ny_of_no_whole_vectors_runs_one_step_per_launch(
        ny, dtype, temporal, cuda_on_cpu, monkeypatch):
    """At an NY the temporal form does not take, Session(temporal=T),
    run_steps, run_steps_probed and Simulation(backend="cuda", temporal=T)
    run one launch of the one-step wrapper per step (no pass), bitwise
    equal to temporal=None; the walls reach column 0."""
    cfg, f, geoms = _scene(16, ny, dtype)
    spec = geoms["spec"]
    want = fk.run_steps(f, geometry.spec_mask(spec, 16, ny), cfg, 7, wall_spec=spec)
    passes = _record_passes(monkeypatch)
    sess = fk.Session(cfg, geometry.spec_mask(spec, 16, ny), device="cpu", wall_spec=spec,
                      temporal=temporal)
    assert (sess.temporal, sess.requested_temporal) == (1, temporal)
    sess.load(f)
    sess.advance(7)
    assert torch.equal(sess.state(), want) and passes == [0] * 7
    passes.clear()
    walls = geometry.spec_mask(spec, 16, ny)
    got = fk.run_steps(f, walls, cfg, 7, wall_spec=spec, temporal=temporal)
    fout, series = fk.run_steps_probed(f, walls, cfg, 6, [(5, 20), (12, 3)], every=3,
                                       wall_spec=spec, temporal=temporal)
    assert torch.equal(got, want) and passes == [0] * 13
    ref_f, ref_series = fk.run_steps_probed(f, walls, cfg, 6, [(5, 20), (12, 3)], every=3,
                                            wall_spec=spec)
    assert torch.equal(fout, ref_f) and torch.equal(series, ref_series)
    passes.clear()
    f0 = f.float().numpy()
    sim = Simulation(cfg, walls, backend="cuda", device="cpu", f0=f0, temporal=temporal)
    ref = Simulation(cfg, walls, backend="cuda", device="cpu", f0=f0)
    sim.run(4).run(3)
    assert passes == [0] * 7 and sim.temporal == temporal and sim._session.temporal == 1
    np.testing.assert_array_equal(sim.state(), ref.run(7).state())


def test_temporal_at_an_ny_of_no_whole_vectors_vs_jax_temporal_blocking():
    """The port at 16x37 (f32), temporal=2, 7 steps (one step per launch by
    shape) against the JAX fused kernel in interpret mode at temporal=2,
    which pads the lanes and runs passes, at the bar of
    test_session_vs_jax_temporal_blocking (rtol 1e-5, atol 1e-7)."""
    jcfg = JaxConfig(nx=16, ny=37, dtype=np.float32)
    walls = jgeo.channel(jcfg.nx, jcfg.ny)
    walls[5:9, 10:13] = True
    want = np.asarray(jfk.run_steps(jnp.asarray(jax_initial_state(jcfg)), jnp.asarray(walls),
                                    jcfg, 7, interpret=True, temporal=2))
    cfg = LatticeConfig(nx=16, ny=37, dtype=np.float32)
    got = fk.run_steps(state_tensor(initial_state(cfg), cfg.dtype, "cpu"), walls, cfg, 7,
                       temporal=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


# ---- against the JAX fused kernel at temporal=T ----

def _jax_walled():
    """tests/test_pallas.py:112-138's scene: 16x40, channel and a 4x3 block."""
    cfg = JaxConfig(nx=16, ny=40, dtype=np.float32)
    walls = jgeo.channel(cfg.nx, cfg.ny)
    walls[5:9, 10:13] = True
    return cfg, walls


@pytest.mark.parametrize("temporal, steps", [(2, 12), (3, 12), (2, 7)])
def test_session_vs_jax_temporal_blocking(temporal, steps):
    """The port's session at temporal=T against the JAX fused kernel in
    interpret mode at the same T (its remainder at T=1), at the JAX test's
    bar, rtol 1e-5 / atol 1e-7 (tests/test_pallas.py:112-138: window shapes
    differ, so XLA fuses differently)."""
    jcfg, walls = _jax_walled()
    want = np.asarray(jfk.run_steps(jnp.asarray(jax_initial_state(jcfg)), jnp.asarray(walls),
                                    jcfg, steps, interpret=True, temporal=temporal))
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    got = fk.run_steps(state_tensor(initial_state(cfg), cfg.dtype, "cpu"), walls, cfg, steps,
                       temporal=temporal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_session_with_a_wall_spec_vs_jax_temporal_blocking():
    """tests/test_pallas.py:234-246's program: the barrier at 64x72 through
    the wall spec, 8 steps at temporal=4; the port's session with the same
    spec at the bar of the walled scene's test."""
    cfg = LatticeConfig(nx=64, ny=72, dtype=np.float32)
    jcfg = JaxConfig(nx=64, ny=72, dtype=np.float32)
    walls = jgeo.build("barrier", 64, 72)
    spec = jgeo.infer_spec(walls)
    want = np.asarray(jfk.run_steps(jnp.asarray(jax_initial_state(jcfg)), jnp.asarray(walls),
                                    jcfg, 8, interpret=True, temporal=4, wall_spec=spec))
    port_spec = geometry.infer_spec(walls)
    assert port_spec == spec
    got = fk.run_steps(state_tensor(initial_state(cfg), cfg.dtype, "cpu"), walls, cfg, 8,
                       wall_spec=port_spec, temporal=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


# ---- the sweep behind DEFAULT_TEMPORAL ----

def test_depth_sweep_exits_2_without_a_card(monkeypatch, capsys):
    from latticeboltzmann_tpu_torch.scripts import depth_sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert depth_sweep.main(["--rounds", "1"]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err


def test_depth_sweep_covers_the_benchmark_configurations():
    """The sweep's default shapes: the benchmark's two configurations
    (800x4000 float32, 4000x16000 bf16) and the other storage at each
    size; its default depths hold T=1 and DEFAULT_TEMPORAL."""
    from latticeboltzmann_tpu_torch.scripts import depth_sweep

    assert depth_sweep._shapes(depth_sweep.SHAPES) == [
        (800, 4000, "float32"), (4000, 16000, "bfloat16"), (4000, 16000, "float32"),
        (800, 4000, "bfloat16")]
    depths = {int(d) for d in depth_sweep.DEPTHS.split(",")}
    assert {1, *fk.DEFAULT_TEMPORAL.values()} <= depths
