"""The rdma form of the row-sharded path (the halo exchange inside the
kernel: ops/fused_kernel.rdma_schedule, rdma_launcher and
step_reference_rdma, parallel/sharded.ShardedRdmaSession, backend
"sharded-cuda-rdma") on CPU meshes, where the kernel's plain version
stands in.

- The schedule replayed in numpy assembles, for 2, 4 and 8 shards, the
  halo rows that exchange_halos copies, and its parity and flag discipline
  holds when a shard runs a step ahead of its neighbours: the twin of
  tests/test_rdma_semantics.py for the port's protocol.
- The path is bitwise equal to the port's "sharded-cuda" on meshes of 1, 2
  and 4 shards (float32 and bf16; wall-free, class plane, wall spec, slip)
  and, in float32, to the JAX "sharded-pallas-interpret" backend over
  meshes of the same sizes. The JAX rdma kernel has no interpret mode
  (ops/fused_kernel.py:1640-1643 there), so the ppermute path is the
  reference, as it is for the JAX package's own schedule test. The scene is
  conftest's small lattice with 32 rows instead of 24: the JAX kernel needs
  8-row tiles per shard. bf16 is held to the port's paths only: the JAX
  planner fuses two bf16 steps per pass and rounds every second step
  (tests/test_torch_bf16.py holds the port's bf16 step to the JAX kernel at
  one step per pass).
- The opt-in, the 2-row shard's single launch, the wrapper's refusals.

tests/test_torch_cuda.py holds the kernel against step_reference_rdma on a
card. Tolerance everywhere: bitwise.
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
from latticeboltzmann_tpu_torch.parallel import sharded
from latticeboltzmann_tpu_torch.utils import interop

torch.set_num_threads(1)

NX, NY, STEPS = 32, 40, 7


def cpu_mesh(n):
    return sharded.make_mesh(devices=["cpu"] * n)


def _walls():
    """conftest's small_walls on 32 rows: a channel with an interior
    barrier across the 2- and 4-shard boundaries at row 16."""
    w = geometry.channel(NX, NY)
    w[12:20, 10:13] = True
    return w


def _slip_scene():
    """A channel whose top wall row is slip_x, with a slip_y block across a
    shard boundary: (walls, slip_x, slip_y)."""
    walls = geometry.channel(NX, NY)
    slip_x = np.zeros_like(walls)
    slip_x[0] = True
    walls[0] = False
    slip_y = np.zeros_like(walls)
    slip_y[14:18, 20:23] = True
    return walls, slip_x, slip_y


def _scene(kind):
    """(walls, Simulation keywords, drop the wall spec) of a geometry kind."""
    if kind == "wall-free":
        return geometry.empty(NX, NY), {}, False
    if kind == "slip":
        walls, slip_x, slip_y = _slip_scene()
        return walls, {"slip_x": slip_x, "slip_y": slip_y}, False
    return _walls(), {}, kind == "plane"


def _guard_off_state(cfg):
    """The rest state with the forcing guard failing at column 0 on both
    sides of the shard boundaries at rows 8 and 16."""
    f = initial_state(cfg)
    f[6, [7, 8, 15, 16], 0] = 1e-6
    return f


def _port_run(monkeypatch, backend, n, cfg, kind, steps=STEPS):
    """`steps` steps of a registered kernel backend of the port over a CPU
    mesh of n shards; returns (state, simulation)."""
    make = {"sharded-cuda-rdma": lambda m: sharded.make_cuda_backend(m, rdma=True),
            "sharded-cuda": sharded.make_cuda_backend}[backend]
    monkeypatch.setitem(engine._BACKENDS, backend, make(cpu_mesh(n)))
    monkeypatch.setattr(engine, "_KERNEL_BACKENDS", set())  # a CPU mesh, for the tests
    walls, kw, drop_spec = _scene(kind)
    if drop_spec:
        # the class-plane variant: the facade infers no spec for the backend
        monkeypatch.setattr(engine, "_WALL_SPEC_BACKENDS", set())
    sim = Simulation(cfg, walls, backend=backend, device="cpu", f0=_guard_off_state(cfg),
                     allow_experimental=True, **kw)
    assert bool(sim.wall_spec) == (kind == "spec")
    return sim.run(steps).state(), sim


# --- (a) the schedule, replayed on the host ---------------------------------


def _replay_sends(blocks, ends, step):
    """Every shard's send role in numpy, by rdma_schedule: rows into the
    neighbours' comm buffers, then their flags."""
    n = len(blocks)
    for k, f in enumerate(blocks):
        s = fk.rdma_schedule(f.shape[1], step)
        up, down = ends[(k + s["up"]) % n], ends[(k + s["down"]) % n]
        up["bot"][s["parity"]] = f[:, s["send_up_row"]]
        up["flags"][s["bot_flag"]] = s["flag"]
        down["top"][s["parity"]] = f[:, s["send_down_row"]]
        down["flags"][s["top_flag"]] = s["flag"]


def _numpy_ends(n, ny):
    return [{"top": np.full((2, 9, ny), np.nan), "bot": np.full((2, 9, ny), np.nan),
             "flags": [0, 0]} for _ in range(n)]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_schedule_assembles_the_halo_rows_of_exchange_halos(n):
    """For 2, 4 and 8 shards the rows a shard finds in its comm buffers at
    the step's parity, once its flags hold the step, are the rows
    exchange_halos copies (all 9 planes): the twin of
    tests/test_rdma_semantics.py:116-142."""
    rng = np.random.default_rng(7 + n)
    L, ny = 5, 12
    for step in (1, 2, 3):
        blocks = [rng.normal(size=(9, L, ny)) for _ in range(n)]
        ends = _numpy_ends(n, ny)
        _replay_sends(blocks, ends, step)
        truth = sharded.exchange_halos([torch.as_tensor(b) for b in blocks],
                                       up=tuple(range(9)), down=tuple(range(9)))
        for k in range(n):
            s = fk.rdma_schedule(L, step)
            assert ends[k]["flags"] == [s["flag"], s["flag"]]
            top, bot = truth[k]
            np.testing.assert_array_equal(ends[k]["top"][s["parity"]], top[:, 0].numpy())
            np.testing.assert_array_equal(ends[k]["bot"][s["parity"]], bot[:, 0].numpy())
            # and they are the neighbours' boundary rows
            np.testing.assert_array_equal(ends[k]["top"][s["parity"]], blocks[(k - 1) % n][:, -1])
            np.testing.assert_array_equal(ends[k]["bot"][s["parity"]], blocks[(k + 1) % n][:, 0])


def test_schedule_rows_parity_and_flags():
    """The rows sent are the rows the neighbours' edge rows read
    (tests/test_rdma_semantics.py:165-178): a shard's first row goes up, its
    last row down; the parity alternates with the step and the flag value
    is the step itself, so flags only ever grow."""
    for rows in (3, 4, 200):
        s = fk.rdma_schedule(rows, 5)
        assert s["parity"] == 1 and s["flag"] == 5
        assert (s["up"], s["down"]) == (-1, +1)
        assert s["send_up_row"] == 0 and s["send_down_row"] == rows - 1
        assert (s["top_flag"], s["bot_flag"]) == (0, 1)
    assert fk.rdma_schedule(8, 6)["parity"] == 0
    assert [fk.rdma_schedule(8, t)["flag"] for t in (1, 2, 3)] == [1, 2, 3]


@pytest.mark.parametrize("n", [2, 4])
def test_a_shard_one_step_ahead_overwrites_nothing_unread(n):
    """The reuse discipline of the comm buffers. Event by event: a shard
    may send step t + 1 as soon as its own step t is complete, while a
    neighbour has not yet read its step-t rows. With two parities and
    monotonic flags the late reader still finds its step-t rows intact and
    its flags at least t; a shard cannot send step t + 2 before every
    neighbour sent t + 1, which they do only after reading step t."""
    rng = np.random.default_rng(3)
    L, ny = 4, 6
    states = {t: [rng.normal(size=(9, L, ny)) for _ in range(n)] for t in (1, 2, 3)}
    ends = _numpy_ends(n, ny)
    sent = [0] * n  # last step each shard sent
    read = [0] * n  # last step whose comm rows each shard consumed

    def send(k, t):
        # the kernel's order: a shard's step t launch follows its step t - 1,
        # whose edge rows waited for both neighbours' step t - 1 rows
        assert sent[k] == t - 1 and read[k] == t - 1
        one = _numpy_ends(n, ny)
        _replay_sends([states[t][j] if j == k else np.zeros((9, L, ny)) for j in range(n)],
                      one, t)
        s = fk.rdma_schedule(L, t)
        for nb, side, flag in (((k - 1) % n, "bot", s["bot_flag"]),
                               ((k + 1) % n, "top", s["top_flag"])):
            # the receiver has consumed what this parity held (step t - 2)
            assert read[nb] >= t - 2
            ends[nb][side][s["parity"]] = one[nb][side][s["parity"]]
            ends[nb]["flags"][flag] = max(ends[nb]["flags"][flag], s["flag"])
        sent[k] = t

    def consume(k, t):
        s = fk.rdma_schedule(L, t)
        assert min(ends[k]["flags"]) >= s["flag"], "an edge row would still wait"
        assert max(ends[k]["flags"]) <= s["flag"] + 1, "a neighbour is two steps ahead"
        np.testing.assert_array_equal(ends[k]["top"][s["parity"]], states[t][(k - 1) % n][:, -1])
        np.testing.assert_array_equal(ends[k]["bot"][s["parity"]], states[t][(k + 1) % n][:, 0])
        read[k] = t

    for k in range(n):
        send(k, 1)
    # shard 0 finishes step 1 and sends step 2 before anyone else read step 1
    consume(0, 1)
    send(0, 2)
    for k in range(1, n):
        consume(k, 1)  # step-1 rows intact though shard 0's step-2 rows arrived
    # shard 0 cannot finish step 2 yet: its neighbours have not sent it
    with pytest.raises(AssertionError, match="would still wait"):
        consume(0, 2)
    for k in range(1, n):
        send(k, 2)
    for k in range(n):
        consume(k, 2)
    for k in range(n):
        send(k, 3)  # overwrites parity 1, which every shard has read
    for k in range(n):
        consume(k, 3)


def test_step_reference_rdma_is_send_then_step_reference_ext():
    """The plain version over a ring of 4: the comm rows it leaves are the
    neighbours' boundary rows, its blocks step_reference_ext's from them,
    and a compute whose neighbour has not sent raises (the plain analog of
    the kernel's bounded wait)."""
    cfg = LatticeConfig(nx=NX, ny=NY, dtype=np.float32)
    n, L = 4, NX // 4
    f = torch.as_tensor(_guard_off_state(cfg))
    srcs = [f[:, k * L:(k + 1) * L].contiguous() for k in range(n)]
    ends = [fk.rdma_end(cfg, "cpu") for _ in range(n)]
    spec = geometry.infer_spec(_walls())
    outs = fk.step_reference_rdma(srcs, ends, [spec] * n, cfg, 1)
    for k in range(n):
        assert ends[k].flags.tolist() == [1, 1] and ends[k].work.tolist() == [0, 0]
        assert torch.equal(ends[k].top[1], srcs[(k - 1) % n][:, -1])
        assert torch.equal(ends[k].bot[1], srcs[(k + 1) % n][:, 0])
        want = fk.step_reference_ext(srcs[k], (ends[k].top[1], ends[k].bot[1]), spec, cfg,
                                     row_offset=k * L)
        assert torch.equal(outs[k], want)
    with pytest.raises(RuntimeError, match="have not arrived"):
        fk.rdma_compute_reference(srcs[0], ends[0], spec, cfg, 2)


# --- (b) the path, against the port's sharded-cuda and the JAX ppermute path --


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("kind", ["wall-free", "plane", "spec", "slip"])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"], ids=["f32", "bf16"])
def test_rdma_path_bitwise_sharded_cuda(monkeypatch, dtype, kind, n):
    cfg = LatticeConfig(nx=NX, ny=NY, dtype=dtype)
    got, sim = _port_run(monkeypatch, "sharded-cuda-rdma", n, cfg, kind)
    assert isinstance(sim._session, sharded.ShardedRdmaSession) and sim._session.rdma
    assert sim._session.step == STEPS
    want, ref_sim = _port_run(monkeypatch, "sharded-cuda", n, cfg, kind)
    assert type(ref_sim._session) is sharded.ShardedSession
    np.testing.assert_array_equal(got, want)
    single = fk.run_steps(interop.state_tensor(_guard_off_state(cfg), cfg.dtype, "cpu"),
                          sim.walls_np, cfg, STEPS, slip_x=sim.slip_x, slip_y=sim.slip_y)
    np.testing.assert_array_equal(got, interop.to_numpy(single))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_rdma_path_bitwise_jax_sharded_pallas_interpret(monkeypatch, n):
    """float32, the wall spec (both facades infer it): equal to the JAX
    ppermute path in interpret mode over a mesh of the same size."""
    monkeypatch.setitem(jax_engine._BACKENDS, "sharded-pallas-interpret",
                        jax_sharded.make_pallas_backend(jax_sharded.make_mesh(n), interpret=True))
    cfg = LatticeConfig(nx=NX, ny=NY, dtype=np.float32)
    ref = JaxSimulation(JaxConfig(nx=NX, ny=NY, dtype=np.float32), _walls(),
                        backend="sharded-pallas-interpret", f0=_guard_off_state(cfg))
    assert ref.wall_spec is not None
    got, sim = _port_run(monkeypatch, "sharded-cuda-rdma", n, cfg, "spec")
    assert sim.wall_spec == ref.wall_spec
    np.testing.assert_array_equal(got, np.asarray(ref.run(STEPS).state()))


@pytest.mark.parametrize("kind", ["plane", "slip"])
def test_rdma_path_bitwise_jax_class_plane_and_slip(monkeypatch, kind):
    """The class-plane geometry (walls, and the slip codes) over 2 shards
    against the JAX ppermute path."""
    monkeypatch.setitem(jax_engine._BACKENDS, "sharded-pallas-interpret",
                        jax_sharded.make_pallas_backend(jax_sharded.make_mesh(2), interpret=True))
    cfg = LatticeConfig(nx=NX, ny=NY, dtype=np.float32)
    walls, kw, drop_spec = _scene(kind)
    ref = JaxSimulation(JaxConfig(nx=NX, ny=NY, dtype=np.float32), walls,
                        backend="sharded-pallas-interpret", f0=_guard_off_state(cfg), **kw)
    if drop_spec:
        ref.wall_spec = None
    assert ref.wall_spec is None
    got, _ = _port_run(monkeypatch, "sharded-cuda-rdma", 2, cfg, kind)
    np.testing.assert_array_equal(got, np.asarray(ref.run(STEPS).state()))


def test_make_cuda_run_steps_rdma_and_reload():
    """make_cuda_run_steps(rdma=True) (the twin of
    make_pallas_run_steps(rdma=True)) equals the overlap runner, fast math
    and all; a session that loads twice starts its flags and step count
    again and gives the same state again."""
    cfg = LatticeConfig(nx=NX, ny=NY, dtype=np.float32)
    f = torch.as_tensor(_guard_off_state(cfg))
    spec = geometry.infer_spec(_walls())
    for fast in (False, True):
        outs = [sharded.make_cuda_run_steps(cpu_mesh(4), cfg, wall_spec=spec, fast_math=fast,
                                            rdma=rdma)(f, _walls(), STEPS)
                for rdma in (True, False)]
        assert torch.equal(*outs)
    sess = sharded.ShardedRdmaSession(cfg, _walls(), mesh=cpu_mesh(4), wall_spec=spec)
    sess.load(f)
    sess.advance(STEPS)
    first = sess.state()
    assert sess.step == STEPS and all(e.flags.tolist() == [STEPS] * 2 for e in sess._ends)
    sess.load(f)
    assert sess.step == 0 and all(e.flags.tolist() == [0, 0] for e in sess._ends)
    sess.advance(STEPS)
    sess.block()
    assert torch.equal(sess.unload(), first) and torch.equal(first, outs[0])


# --- (c), (d) and the refusals -----------------------------------------------


def test_rdma_backend_needs_the_opt_in():
    """JAX models/engine.py:213-233: without allow_experimental the backend
    raises RuntimeError naming the flag; with it, on this machine, the
    kernel backend asks for its card."""
    assert "sharded-cuda-rdma" in engine.available_backends()
    assert "sharded-cuda-rdma" in engine._EXPERIMENTAL_BACKENDS
    cfg = LatticeConfig(nx=NX, ny=NY, dtype=np.float32)
    with pytest.raises(RuntimeError, match="allow_experimental=True"):
        Simulation(cfg, _walls(), backend="sharded-cuda-rdma")
    with pytest.raises(RuntimeError, match="allow_experimental=True"):
        Simulation(cfg, _walls(), backend="sharded-cuda-rdma", device="cpu")
    with pytest.raises(ValueError, match="runs on a CUDA device"):
        Simulation(cfg, _walls(), backend="sharded-cuda-rdma", device="cpu",
                   allow_experimental=True)
    for name in ("_KERNEL_BACKENDS", "_SLIP_BACKENDS", "_FASTMATH_BACKENDS",
                 "_WALL_SPEC_BACKENDS"):
        assert "sharded-cuda-rdma" in getattr(engine, name)


def test_a_two_row_shard_takes_the_single_launch():
    """A shard of fewer than 3 rows has no interior to overlap with: the
    session keeps ShardedSession's exchange-then-launch (one launch per
    shard, halo copies from the host), as the JAX runner does
    (parallel/sharded.py:335-336 there), bitwise the same state."""
    cfg = LatticeConfig(nx=8, ny=NY, dtype=np.float32)
    walls = geometry.channel(8, NY)
    f = torch.as_tensor(initial_state(cfg))
    sess = sharded.ShardedRdmaSession(cfg, walls, mesh=cpu_mesh(4))
    assert not sess.rdma and sess._ends is None and sess.L == 2
    sess.load(f)
    copies, interior, edges = sess._plans[0]
    assert len(copies) == 8 and interior == []
    assert sum(len(calls) for _, calls in edges) == 4
    before = sharded.HALO_COPIES
    sess.advance(5)
    assert sharded.HALO_COPIES - before == 5 * 8
    assert torch.equal(sess.unload(), fk.run_steps(f, walls, cfg, 5))
    # three rows do take the rdma form, and no copy from the host
    cfg3 = LatticeConfig(nx=12, ny=NY, dtype=np.float32)
    walls3 = geometry.channel(12, NY)
    f3 = torch.as_tensor(initial_state(cfg3))
    sess = sharded.ShardedRdmaSession(cfg3, walls3, mesh=cpu_mesh(4))
    assert sess.rdma and sess.L == 3
    sess.load(f3)
    before = sharded.HALO_COPIES
    sess.advance(5)
    assert sharded.HALO_COPIES == before
    assert torch.equal(sess.unload(), fk.run_steps(f3, walls3, cfg3, 5))


def test_rdma_launcher_refusals():
    cfg = LatticeConfig(nx=NX, ny=NY, dtype=np.float32)
    src = torch.zeros(9, 8, NY)
    dst = torch.zeros_like(src)
    end = fk.rdma_end(cfg, "cpu")
    assert end.top.shape == (2, 9, NY) and end.flags.dtype == torch.int64
    fk.rdma_launcher(src, dst, end, end, end, None, cfg)  # a ring of one
    with pytest.raises(ValueError, match="at least 3 rows"):
        fk.rdma_launcher(src[:, :2].contiguous(), dst[:, :2].contiguous(), end, end, end, None, cfg)
    with pytest.raises(ValueError, match="distinct buffers"):
        fk.rdma_launcher(src, src, end, end, end, None, cfg)
    bad = end._replace(flags=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="int64"):
        fk.rdma_launcher(src, dst, end, bad, end, None, cfg)
    bad = end._replace(bot=torch.zeros(2, 9, NY + 1))
    with pytest.raises(ValueError, match="comm rows"):
        fk.rdma_launcher(src, dst, end, end, bad, None, cfg)
    cfg16 = LatticeConfig(nx=NX, ny=NY, dtype="bfloat16")
    with pytest.raises(ValueError):
        fk.rdma_launcher(src, dst, fk.rdma_end(cfg16, "cpu"), end, end, None, cfg)
    # a ring of one on the CPU: launch(step) is send then compute
    f = torch.as_tensor(initial_state(LatticeConfig(nx=8, ny=NY, dtype=np.float32)))
    cfg8 = LatticeConfig(nx=8, ny=NY, dtype=np.float32)
    out = torch.zeros_like(f)
    fk.rdma_launcher(f, out, end, end, end, None, cfg8)(1)
    assert torch.equal(out, fk.step_reference(f, None, cfg8))
    assert fk.rdma_timed_out(end) == 0
    fk.rdma_reset(end)
    assert end.flags.tolist() == [0, 0]
