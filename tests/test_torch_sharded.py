"""The row-sharded path of the port (parallel/sharded.py) on CPU meshes of
virtual shards, against the JAX package's sharded backend and the port's
single-chip paths.

- The eager runner ("sharded", "sharded-sync") on 8 CPU shards is
  bitwise equal to the JAX "sharded" backend on conftest's 8 virtual
  devices, in float64, float32 and bf16 (the JAX backend is itself
  bitwise equal to its xla engine, tests/test_sharded.py:33-61, :241-253).
- The kernel runners (make_cuda_run_steps, make_cuda_ds_run_steps), whose
  ext-halo launches take their plain versions on the CPU
  (fused_kernel.step_reference_ext, fused_ds_kernel.step_reference_ext),
  are bitwise equal to the single-chip runners on the CPU
  (fused_kernel.run_steps, fused_ds_kernel.run_steps) on meshes of 1, 2,
  4 and 8 shards, both schedules: the halo exchange is invisible.
  tests/test_torch_cuda.py holds the ext-halo kernels against those plain
  versions on a card.

The JAX interpret-mode sharded backends are not run here: the port's
single-chip plain versions are already held against the JAX kernels in
interpret mode (tests/test_torch_kernel.py, test_torch_options.py,
test_torch_ds.py). Every scene turns the forcing guard off at column-0
sites on both sides of shard boundaries, so a halo row's own guard
decides whether the rows pulled from it are forced.
"""

import functools

import jax.numpy as jnp
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
from latticeboltzmann_tpu_torch.parallel import sharded
from latticeboltzmann_tpu_torch.utils import interop

torch.set_num_threads(1)

DTYPES = {"float64": (np.float64, np.float64), "float32": (np.float32, np.float32),
          "bfloat16": ("bfloat16", jnp.bfloat16)}


def cpu_mesh(n):
    return sharded.make_mesh(devices=["cpu"] * n)


def _walls_32x48():
    """tests/test_sharded.py:15-25's scene."""
    w = geometry.channel(32, 48)
    w[10:20, 12:15] = True
    return w


@functools.lru_cache(maxsize=None)
def _jax_sharded(dtype_name, n_steps):
    """The JAX "sharded" backend on conftest's 8 virtual devices: the
    state after n_steps, as float64 (exact for every dtype here)."""
    jcfg = JaxConfig(nx=32, ny=48, dtype=DTYPES[dtype_name][1])
    out = JaxSimulation(jcfg, _walls_32x48(), backend="sharded").run(n_steps).state()
    return np.asarray(out, np.float64)


@pytest.mark.parametrize("overlap", [True, False], ids=["sharded", "sharded-sync"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_eager_runner_bitwise_jax_sharded(dtype_name, overlap):
    cfg = LatticeConfig(nx=32, ny=48, dtype=DTYPES[dtype_name][0])
    walls = _walls_32x48()
    f = interop.state_tensor(initial_state(cfg), cfg.dtype, "cpu")
    run = sharded.make_backend(cpu_mesh(8), overlap=overlap)
    out = run(f, torch.as_tensor(walls), cfg, 10)
    assert out.dtype == f.dtype and out.shape == f.shape
    np.testing.assert_array_equal(out.double().numpy(), _jax_sharded(dtype_name, 10))


def test_registered_backends_run_on_the_default_mesh():
    """"sharded" and "sharded-sync" through the facade on make_mesh(),
    the CPU alone here: one shard, its own ring neighbour."""
    cfg = LatticeConfig(nx=32, ny=48, dtype=np.float64)
    assert sharded.make_mesh().devices == (torch.device("cpu"),)
    for backend in ("sharded", "sharded-sync"):
        out = Simulation(cfg, _walls_32x48(), backend=backend, device="cpu").run(10).state()
        np.testing.assert_array_equal(out, _jax_sharded("float64", 10))


def test_overlap_equals_sync():
    """tests/test_sharded.py:42-45: both schedules, 7 steps, 8 shards, and
    the uneven meshes of 2 and 4."""
    cfg = LatticeConfig(nx=32, ny=48, dtype=np.float64)
    f = torch.as_tensor(initial_state(cfg))
    walls = torch.as_tensor(_walls_32x48())
    outs = [sharded.make_backend(cpu_mesh(n), overlap=ov)(f, walls, cfg, 7)
            for n in (2, 4, 8) for ov in (True, False)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def test_eager_slip_bitwise_torch_engine():
    """Slip masks ride the shards: equal to the torch engine's slip step
    (itself bitwise the JAX xla engine's, tests/test_torch_options.py)."""
    cfg = LatticeConfig(nx=32, ny=48, dtype=np.float32)
    walls, slip_x, slip_y = _slip_scene(32, 48)
    f = torch.as_tensor(initial_state(cfg))
    out = sharded.make_backend(cpu_mesh(8))(f, torch.as_tensor(walls), cfg, 6,
                                            slip_x=torch.as_tensor(slip_x),
                                            slip_y=torch.as_tensor(slip_y))
    ref = Simulation(cfg, walls, backend="torch", device="cpu", slip_x=slip_x,
                     slip_y=slip_y).run(6).f
    assert torch.equal(out, ref)


@pytest.mark.parametrize("runner", ["eager", "kernel"])
def test_packet_crosses_a_shard_boundary(runner):
    """tests/test_sharded.py:76-92: empty box, no collision, an f2 (+x)
    packet on the last row of shard 0 arrives on shard 1's first row."""
    cfg = LatticeConfig(nx=32, ny=48, dtype=np.float32, tau=1e9, accel=0.0)
    walls = geometry.empty(cfg.nx, cfg.ny)
    f = initial_state(cfg)
    f[2, 3, 5] += 1.0  # shard 0 holds rows 0-3 of 8 shards
    f = torch.as_tensor(f)
    if runner == "eager":
        out = sharded.make_run_steps(cpu_mesh(8), cfg)(f, torch.as_tensor(walls), 1)
    else:
        out = sharded.make_cuda_run_steps(cpu_mesh(8), cfg)(f, walls, 1)
    assert out[2, 4, 5] > 1.0 and out[2, 3, 5] < 1.0


def _slip_scene(nx, ny):
    """A channel whose top wall row is slip_x, with a slip_y block across
    a shard boundary: (walls, slip_x, slip_y)."""
    walls = geometry.channel(nx, ny)
    slip_x = np.zeros_like(walls)
    slip_x[0] = True
    walls[0] = False
    slip_y = np.zeros_like(walls)
    slip_y[nx // 2 - 1: nx // 2 + 1, 20:22] = True
    return walls, slip_x, slip_y


def _scene_24x40(dtype):
    """24x40, a rect on columns 0-2 across shard boundaries (rows 8-13):
    the halo class rows and the spec's global rows matter. The forcing
    guard is off at column 0 of rows 2, 3, 5, 6, 11, 12 (each on one side
    of a boundary of the 8-, 4- or 2-shard mesh)."""
    cfg = LatticeConfig(nx=24, ny=40, dtype=dtype, accel=0.005)
    walls = geometry.channel(24, 40)
    walls[8:14, 0:3] = True
    rng = np.random.default_rng(7)
    f = initial_state(cfg) * (1 + 0.05 * rng.uniform(-1, 1, (9, 24, 40)))
    f[6, [2, 3, 5, 6, 11, 12], 0] = 1e-6
    return cfg, walls, f


def _geometry(name, walls):
    """(walls, options) of a kernel runner for a geometry source."""
    if name == "none":
        return geometry.empty(*walls.shape), {}
    if name == "plane":
        return walls, {}
    if name == "spec":
        spec = geometry.infer_spec(walls)
        assert spec is not None
        return walls, {"wall_spec": spec}
    w, sx, sy = _slip_scene(*walls.shape)
    return w, {"slip_x": sx, "slip_y": sy}


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("geom", ["none", "plane", "spec", "slip"])
def test_kernel_runner_bitwise_single_chip(geom, n, overlap):
    """make_cuda_run_steps on n CPU shards, 5 steps (odd), equals
    fused_kernel.run_steps on the CPU bitwise."""
    cfg, walls, f0 = _scene_24x40(np.float32)
    walls, options = _geometry(geom, walls)
    f = torch.as_tensor(f0.astype(np.float32))
    ref = fk.run_steps(f, walls, cfg, 5, **options)
    slip = "slip_x" in options
    if slip:
        walls = fk.class_plane(walls, options.pop("slip_x"), options.pop("slip_y"))
    run = sharded.make_cuda_run_steps(cpu_mesh(n), cfg, overlap=overlap, has_slip=slip,
                                      **options)
    out = run(f, walls, 5)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("geom", ["plane", "spec"])
def test_kernel_runner_bf16_and_fast_math(geom):
    """bf16 storage (one rounding per step, as the single-chip form) and
    the fast-math flag (IEEE in the plain version) on 4 shards."""
    cfg, walls, f0 = _scene_24x40("bfloat16")
    walls, options = _geometry(geom, walls)
    f = interop.state_tensor(f0.astype(np.float32), cfg.dtype, "cpu")
    for fast in (False, True):
        ref = fk.run_steps(f, walls, cfg, 3, fast_math=fast, **options)
        out = sharded.make_cuda_run_steps(cpu_mesh(4), cfg, fast_math=fast, **options)(f, walls, 3)
        assert out.dtype == torch.bfloat16 and torch.equal(out, ref)


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ds_runner_bitwise_single_chip(n, overlap):
    """make_cuda_ds_run_steps on n CPU shards, 3 steps, fast tier (and
    the exact tier on 4 shards), equals fused_ds_kernel.run_steps."""
    cfg, walls, f0 = _scene_24x40(np.float64)
    f = df64.from_f64(f0, "cpu")
    tiers = (False, True) if n == 4 else (False,)
    for exact in tiers:
        ref = fdk.run_steps(f, walls, cfg, 3, exact=exact)
        out = sharded.make_cuda_ds_run_steps(cpu_mesh(n), cfg, exact=exact, overlap=overlap)(
            f, walls, 3)
        assert torch.equal(out.hi, ref.hi) and torch.equal(out.lo, ref.lo)
    empty = geometry.empty(24, 40)
    ref = fdk.run_steps(f, empty, cfg, 3)
    out = sharded.make_cuda_ds_run_steps(cpu_mesh(n), cfg, overlap=overlap)(f, empty, 3)
    assert torch.equal(out.hi, ref.hi) and torch.equal(out.lo, ref.lo)


def test_facade_runs_a_kernel_backend_over_a_cpu_mesh(monkeypatch):
    """The JAX idiom: a backend registered over a chosen mesh. Over CPU
    shards the sessions run the plain versions; the facade keeps them
    across run() calls, and its state equals the single-chip runners'."""
    cfg, walls, f0 = _scene_24x40(np.float32)
    monkeypatch.setitem(engine._BACKENDS, "_sharded_kernel",
                        sharded.make_cuda_backend(cpu_mesh(4), overlap=True))
    sim = Simulation(cfg, walls, backend="_sharded_kernel", device="cpu", f0=f0)
    assert isinstance(sim._session, sharded.ShardedSession)
    sim.run(2).run(3)
    ref = fk.run_steps(torch.as_tensor(f0.astype(np.float32)), walls, cfg, 5)
    assert torch.equal(torch.as_tensor(sim.state()), ref)
    cfg64, _, f64 = _scene_24x40(np.float64)
    monkeypatch.setitem(engine._BACKENDS, "_sharded_ds",
                        sharded.make_cuda_ds_backend(cpu_mesh(2)))
    monkeypatch.setattr(engine, "_DS_BACKENDS", engine._DS_BACKENDS | {"_sharded_ds"})
    sim = Simulation(cfg64, walls, backend="_sharded_ds", device="cpu", f0=f64).run(3)
    ref = fdk.run_steps(df64.from_f64(f64, "cpu"), walls, cfg64, 3)
    np.testing.assert_array_equal(sim.state(), interop.to_numpy(fdk.ds_engine.recombine(ref)))


def test_uneven_rows_raise():
    """NX % n != 0 raises, as sharded.py:261-262."""
    cfg = LatticeConfig(nx=30, ny=40, dtype=np.float32)
    cfg64 = LatticeConfig(nx=30, ny=40, dtype=np.float64)
    for build in (lambda: sharded.make_run_steps(cpu_mesh(4), cfg),
                  lambda: sharded.make_cuda_run_steps(cpu_mesh(4), cfg),
                  lambda: sharded.make_cuda_ds_run_steps(cpu_mesh(4), cfg64),
                  lambda: sharded.ShardedSession(cfg, geometry.empty(30, 40), mesh=cpu_mesh(8))):
        with pytest.raises(ValueError, match="not divisible"):
            build()


def test_exchange_halos_copies_the_ring_neighbours_rows():
    """exchange_halos (through a HaloExchange over the shards' devices):
    shard k's top rows are the UP_SPEEDS planes of shard k-1's last row,
    its bottom rows the DOWN_SPEEDS planes of shard k+1's first row."""
    rng = np.random.default_rng(3)
    shards = [torch.as_tensor(rng.uniform(size=(9, 3, 5))) for _ in range(4)]
    halos = sharded.exchange_halos(shards)
    for k, (top, bot) in enumerate(halos):
        assert torch.equal(top, shards[k - 1][list(sharded.UP_SPEEDS), -1:])
        assert torch.equal(bot, shards[(k + 1) % 4][list(sharded.DOWN_SPEEDS), :1])


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_kernel_sessions_refuse_a_mesh_of_another_device_type(device):
    """A card's state over a CPU mesh raises: the kernel runs where the
    shards lie, and the plain version never stands in on the CPU behind
    a card's tensors."""
    cfg, walls, _ = _scene_24x40(np.float32)
    cfg64 = LatticeConfig(nx=24, ny=40, dtype=np.float64)
    for build in (lambda: sharded.ShardedSession(cfg, walls, mesh=cpu_mesh(2), device=device),
                  lambda: sharded.make_cuda_backend(cpu_mesh(4)).session(cfg, walls,
                                                                         device=device),
                  lambda: sharded.ShardedDSSession(cfg64, walls, mesh=cpu_mesh(2),
                                                   device=device),
                  lambda: sharded.make_cuda_ds_backend(cpu_mesh(4)).session(cfg64, walls,
                                                                            device=device)):
        with pytest.raises(ValueError, match="not of the state's device type"):
            build()


@pytest.mark.parametrize("backend", ["sharded-cuda", "sharded-cuda-fused", "sharded-cuda-ds64"])
def test_kernel_backends_raise_without_a_card(backend):
    """As "cuda": the kernel backends run on a card or raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float64 if "ds64" in backend else np.float32)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        Simulation(cfg, backend=backend)
    with pytest.raises(ValueError, match="runs on a CUDA device"):
        Simulation(cfg, backend=backend, device="cpu")


def _ext_refusal(case):
    cfg, walls, f0 = _scene_24x40(np.float32)
    src = torch.as_tensor(f0.astype(np.float32))[:, :6].contiguous()
    dst = torch.empty_like(src)
    halo = (torch.zeros(9, 40), torch.zeros(9, 40))
    if case == "edge_without_halo":
        return lambda: fk.ext_launcher(src, dst, None, None, cfg, row0=0, rows=2)
    if case == "rows_outside":
        return lambda: fk.ext_launcher(src, dst, halo, None, cfg, row0=4, rows=3)
    if case == "offset_outside":
        return lambda: fk.ext_launcher(src, dst, halo, None, cfg, row_offset=20)
    if case == "halo_shape":
        return lambda: fk.ext_launcher(src, dst, (halo[0][:3], halo[1]), None, cfg)
    if case == "plane_not_sharded":
        plane = torch.as_tensor(walls.astype(np.uint8))
        return lambda: fk.ext_launcher(src, dst, halo, plane, cfg)
    if case == "ds_edge_without_halo":
        cfg64 = LatticeConfig(nx=24, ny=40, dtype=np.float64)
        a = df64.from_f64(f0[:, :6], "cpu")
        b = df64.DS(torch.empty_like(a.hi), torch.empty_like(a.lo))
        return lambda: fdk.ext_launcher(a, b, None, None, cfg64, has_walls=False, row0=5)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["edge_without_halo", "rows_outside", "offset_outside",
                                  "halo_shape", "plane_not_sharded", "ds_edge_without_halo"])
def test_ext_launcher_refuses(case):
    before = (fk.EXT_LAUNCHES, fdk.EXT_LAUNCHES)
    with pytest.raises(ValueError):
        _ext_refusal(case)()
    assert (fk.EXT_LAUNCHES, fdk.EXT_LAUNCHES) == before


def test_ext_launcher_on_meta_raises():
    """A tensor on neither the CPU nor a card raises: no plain-version
    fallback behind a device tensor."""
    cfg = LatticeConfig(nx=24, ny=40, dtype=np.float32)
    src = torch.empty(9, 6, 40, device="meta")
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        fk.ext_launcher(src, torch.empty_like(src), None, None, cfg, row0=1, rows=4)
