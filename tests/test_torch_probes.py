"""The port's probed run (Simulation.run_probed) and its probe gathers
on the CPU, against the JAX package's run_probed on the same seeded
inputs: the twin of tests/test_probes.py.

The JAX side runs as tests/test_probes.py runs it: "xla", the Pallas
kernel in interpret mode ("pallas-interpret", "pallas-ds64-interpret")
and the sharded interpret path over conftest's 8 virtual CPU devices. The
port's kernel backends run their kernels' plain versions on the CPU (a
CPU mesh, or _KERNEL_BACKENDS emptied for the test, as
tests/test_torch_simulation.py does).

Bars (docs/NUMERICS.md's ladder): bitwise wherever the port's own tests
hold the two states bitwise (the float64 eager engine against golden,
bf16 kernel against pallas-interpret, every sharded backend against
the JAX sharded backend of the same name, the ds pair against xla-ds64 and the ds
kernel against its interpret twin, and every port backend against the
same port backend's run() with probe_values between chunks); the float32
single-chip kernel against pallas-interpret at the ladder's 5e-7 (its
state's bar, tests/test_torch_kernel.py); the float64 engine against
the jitted JAX engine at 1e-13 (tests/test_probes.py's own bar).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu import Simulation as JaxSimulation
from latticeboltzmann_tpu.models import golden
from latticeboltzmann_tpu.ops.stream_collide import probe_moments as jax_probe_moments
from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.core.spec import W
from latticeboltzmann_tpu_torch.models import engine
from latticeboltzmann_tpu_torch.ops import df64, ds_engine, fused_ds_kernel, fused_kernel
from latticeboltzmann_tpu_torch.ops import stream_collide
from latticeboltzmann_tpu_torch.parallel import sharded

torch.set_num_threads(1)

# tests/test_probes.py's sites
PROBES = np.array([[5, 7], [12, 30], [1, 0]], dtype=np.int32)
# the float32 kernel's state bar against pallas-interpret (docs/NUMERICS.md)
KERNEL_ATOL = 5e-7
# the float64 engine against the jitted JAX engine (tests/test_probes.py)
F64_ATOL = 1e-13


def _walls(nx=24, ny=40):
    """conftest's small_walls (a channel with an interior barrier)."""
    w = geometry.channel(nx, ny)
    w[8:14, 10:13] = True
    return w


def _pair(dtype, nx=24, ny=40):
    return LatticeConfig(nx=nx, ny=ny, dtype=dtype), JaxConfig(
        nx=nx, ny=ny, dtype=np.float32 if dtype == "bfloat16" else dtype)


def _cpu_mesh(n):
    return sharded.make_mesh(devices=["cpu"] * n)


def _on_cpu(monkeypatch, backend, shards=None):
    """Let a kernel backend run on the CPU (its plain version); a sharded
    one over a CPU mesh of `shards`."""
    monkeypatch.setattr(engine, "_KERNEL_BACKENDS", set())
    make = {"sharded": lambda m: sharded.make_backend(m),
            "sharded-sync": lambda m: sharded.make_backend(m, overlap=False),
            "sharded-cuda": sharded.make_cuda_backend,
            "sharded-cuda-fused": lambda m: sharded.make_cuda_backend(m, overlap=False),
            "sharded-cuda-rdma": lambda m: sharded.make_cuda_backend(m, rdma=True),
            "sharded-cuda-ds64": sharded.make_cuda_ds_backend}.get(backend)
    if make is not None:
        monkeypatch.setitem(engine._BACKENDS, backend, make(_cpu_mesh(shards)))


def _sim(backend, cfg, walls, **kw):
    return Simulation(cfg, walls, backend=backend, device="cpu", allow_experimental=True, **kw)


def _chunked(sim, n_steps, every, probes=PROBES):
    """run() of `every` steps, then probe_values: the series run_probed
    must equal."""
    return np.stack([sim.run(every).probe_values(probes) for _ in range(n_steps // every)])


def _golden_series(cfg, walls, n_steps, probes):
    f = golden.initial_state(cfg)
    rows = []
    for _ in range(n_steps):
        f = golden.step(f, walls, cfg)
        rho, ux, uy = golden.macroscopic(f)
        rows.append(np.stack([m[probes[:, 0], probes[:, 1]] for m in (rho, ux, uy)], axis=-1))
    return f, np.stack(rows)


def test_probed_series_matches_golden():
    """The float64 engine's per-step series (run_probed at every = 1) is
    golden's bit for bit, its state too, and the JAX xla series within
    its own bar; probing leaves the trajectory as it was."""
    cfg, jcfg = _pair(np.float64)
    walls = _walls()
    sim = _sim("torch", cfg, walls)
    series = sim.run_probed(6, PROBES)
    f_ref, series_ref = _golden_series(jcfg, walls, 6, PROBES)
    assert series.shape == (6, 3, 3) and series.dtype == np.float64
    np.testing.assert_array_equal(series, series_ref)
    np.testing.assert_array_equal(sim.state(), f_ref)
    assert sim.steps_done == 6 and sim.elapsed > 0
    jax_series = JaxSimulation(jcfg, walls, backend="xla").run_probed(6, PROBES)
    np.testing.assert_allclose(series, jax_series, rtol=0, atol=F64_ATOL)


def test_run_steps_probed_is_run_steps_plus_a_gather():
    """stream_collide.run_steps_probed and fused_kernel.run_steps_probed
    (its plain version on the CPU): the final state of run_steps, the
    series of probe_values after each step (every `every`), f unchanged."""
    cfg, _ = _pair(np.float32)
    walls = torch.as_tensor(_walls())
    f0 = torch.as_tensor(engine.initial_state(cfg))
    keep = f0.clone()
    f, series = stream_collide.run_steps_probed(f0, walls, cfg, 4, PROBES)
    assert torch.equal(f0, keep) and series.dtype == torch.float32
    assert torch.equal(f, stream_collide.run_steps(f0, walls, cfg, 4))
    g = f0
    for k in range(4):
        g = stream_collide.step(g, walls, cfg)
        assert torch.equal(series[k], stream_collide.probe_values(g, PROBES))
    f, series = fused_kernel.run_steps_probed(f0, walls.numpy(), cfg, 6, PROBES, every=3)
    assert torch.equal(f0, keep) and series.shape == (2, 3, 3)
    assert torch.equal(f, fused_kernel.run_steps(f0, walls.numpy(), cfg, 6))
    assert torch.equal(series[1], stream_collide.probe_values(f, PROBES))


@pytest.mark.parametrize("backend,dtype,shards", [
    ("torch", np.float64, None), ("torch", np.float32, None), ("cuda", np.float32, None),
    ("cuda", "bfloat16", None), ("torch-ds64", np.float64, None),
    ("cuda-ds64", np.float64, None), ("sharded", np.float32, 2),
    ("sharded-sync", np.float64, 4), ("sharded-cuda", np.float32, 2),
    ("sharded-cuda-fused", "bfloat16", 4), ("sharded-cuda-rdma", np.float32, 4),
    ("sharded-cuda-ds64", np.float64, 2),
])
def test_probed_equals_unprobed_and_chunked(monkeypatch, backend, dtype, shards):
    """On every backend the port registers: the probed state equals the
    unprobed state, and the series equals run() with probe_values between
    chunks, at every = 1, 8 and 3, bit for bit; every = 8 and 3 sample
    the rows of the every = 1 series."""
    _on_cpu(monkeypatch, backend, shards)
    cfg, _ = _pair(dtype)
    walls = _walls()
    final = _sim(backend, cfg, walls).run(24).state()
    series1 = None
    for every in (1, 8, 3):
        sim = _sim(backend, cfg, walls)
        series = sim.run_probed(24, PROBES, every=every)
        assert series.shape == (24 // every, 3, 3) and sim.steps_done == 24
        assert series.dtype == (np.float64 if dtype == np.float64 else np.float32)
        np.testing.assert_array_equal(sim.state(), final)
        np.testing.assert_array_equal(series, _chunked(_sim(backend, cfg, walls), 24, every))
        if series1 is None:
            series1 = series
        np.testing.assert_array_equal(series, series1[every - 1::every])


@pytest.mark.parametrize("backend", ["torch", "cuda", "sharded-cuda", "torch-ds64"])
def test_probe_validation(monkeypatch, backend):
    """The JAX checks (every divides n_steps, (P, 2) sites), and sites
    inside the lattice with integer indices: ValueError before any step."""
    _on_cpu(monkeypatch, backend, 2)
    cfg, _ = _pair(np.float64 if backend.endswith("ds64") else np.float32)
    sim = _sim(backend, cfg, _walls())
    with pytest.raises(ValueError, match="not divisible"):
        sim.run_probed(5, PROBES, every=2)
    with pytest.raises(ValueError, match=r"\(P, 2\)"):
        sim.run_probed(4, np.array([1, 2, 3]))
    with pytest.raises(ValueError, match="outside"):
        sim.run_probed(4, np.array([[24, 0]]))
    with pytest.raises(ValueError, match="outside"):
        sim.probe_values(np.array([[0, -1]]))
    with pytest.raises(ValueError, match="integers"):
        sim.probe_values(np.array([[0.5, 1.0]]))
    assert sim.steps_done == 0
    jsim = JaxSimulation(JaxConfig(nx=24, ny=40, dtype=np.float32), _walls(), backend="xla")
    with pytest.raises(ValueError):
        jsim.run_probed(5, PROBES, every=2)


@pytest.mark.parametrize("every,n", [(1, 6), (8, 16), (3, 6)])
def test_cuda_probes_vs_jax_pallas_interpret(monkeypatch, every, n):
    """"cuda" (its plain version) against "pallas-interpret" at
    tests/test_probes.py's every = 1, 8 and 3: float32 series within the
    kernel's state bar; the port's every-series samples its every = 1
    series bitwise."""
    _on_cpu(monkeypatch, "cuda")
    cfg, jcfg = _pair(np.float32)
    walls = _walls()
    got = _sim("cuda", cfg, walls).run_probed(n, PROBES, every=every)
    want = JaxSimulation(jcfg, walls, backend="pallas-interpret").run_probed(
        n, PROBES, every=every)
    assert got.shape == want.shape == (n // every, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=KERNEL_ATOL)
    per_step = _sim("cuda", cfg, walls).run_probed(n, PROBES)
    np.testing.assert_array_equal(got, per_step[every - 1::every])


def test_bf16_cuda_probes_bitwise_jax_pallas_interpret(monkeypatch):
    """bf16 storage: the kernel's plain version is bitwise the JAX kernel
    in interpret mode (tests/test_torch_bf16.py), and so is the series,
    its moments accumulated in float32."""
    _on_cpu(monkeypatch, "cuda")
    cfg, _ = _pair("bfloat16")
    jcfg = JaxConfig(nx=24, ny=40, dtype=jnp.bfloat16)
    walls = _walls()
    got = _sim("cuda", cfg, walls).run_probed(6, PROBES, every=3)
    want = JaxSimulation(jcfg, walls, backend="pallas-interpret").run_probed(6, PROBES, every=3)
    assert got.dtype == np.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _sharded_case(monkeypatch, backend, jax_backend, dtype):
    """tests/test_probes.py's sharded case (64x40, every = 2): the port's
    backend over 8 CPU shards against the JAX backend over conftest's 8
    virtual devices, series and state bitwise."""
    _on_cpu(monkeypatch, backend, 8)
    cfg, jcfg = _pair(dtype, nx=64)
    walls = geometry.channel(64, 40)
    walls[20:30, 10:13] = True
    sim = _sim(backend, cfg, walls)
    got = sim.run_probed(8, PROBES, every=2)
    jsim = JaxSimulation(jcfg, walls, backend=jax_backend)
    want = jsim.run_probed(8, PROBES, every=2)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sim.state(), np.asarray(jsim.state()))


@pytest.mark.parametrize("backend,jax_backend,dtype", [
    pytest.param(backend, jax_backend, dtype, id=backend) for backend, jax_backend, dtype in [
        ("sharded-cuda", "sharded-pallas-interpret", np.float32),
        ("sharded-cuda-fused", "sharded-pallas-fused-interpret", np.float32),
        ("sharded-cuda-rdma", "sharded-pallas-interpret", np.float32),
        ("sharded-cuda-ds64", "sharded-pallas-ds64-interpret", np.float64)]])
def test_sharded_kernel_probes_bitwise_jax_sharded_interpret(monkeypatch, backend,
                                                              jax_backend, dtype):
    """The kernel sessions, each probe gathered on the shard that owns its
    row, against the JAX sharded Pallas paths in interpret mode (the ds
    pair's series in float64 from the pair recombined)."""
    _sharded_case(monkeypatch, backend, jax_backend, dtype)


@pytest.mark.parametrize("backend", ["sharded", "sharded-sync"])
def test_eager_sharded_probes_bitwise_jax_sharded(monkeypatch, backend):
    """The eager runners against the JAX backends of the same names (the
    JAX facade's generic branch on both sides)."""
    _sharded_case(monkeypatch, backend, backend, np.float32)


@pytest.mark.parametrize("backend,jax_backend", [("torch-ds64", "xla-ds64"),
                                                 ("cuda-ds64", "pallas-ds64-interpret")])
def test_ds_probes_bitwise_jax(monkeypatch, backend, jax_backend):
    """The ds backends sample in float64 from the pair recombined: the
    exact-tier engine against xla-ds64, the fast-tier kernel's plain
    version against its JAX twin in interpret mode, bitwise (the JAX
    facade recombines on the host; the port only the probe columns, on
    the device)."""
    _on_cpu(monkeypatch, backend)
    cfg, jcfg = _pair(np.float64, nx=16)
    walls = _walls(16)
    got = _sim(backend, cfg, walls).run_probed(4, PROBES[:2], every=2)
    want = JaxSimulation(jcfg, walls, backend=jax_backend).run_probed(4, PROBES[:2], every=2)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_probe_moments_accumulate_f32_for_bf16():
    """tests/test_probes.py:157 on the port: bf16 columns give float32
    moments, equal to the JAX probe_moments, and a sub-quantum u_y excess
    survives; the ds gather of the pair's columns equals the gather of
    the recombined state."""
    cols64 = np.broadcast_to(0.1 * W[:, None], (9, 4)).copy()
    cols64[1] += 1e-4
    cols16 = torch.as_tensor(cols64, dtype=torch.bfloat16)
    out = stream_collide.probe_moments(cols16)
    assert out.dtype == torch.float32
    ref = np.asarray(jax_probe_moments(jnp.asarray(cols16.float().numpy(), jnp.bfloat16)))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out[:, 2] > 0).all()
    rng = np.random.default_rng(0)
    pair = df64.from_f64(rng.uniform(0.01, 0.1, (9, 8, 10)), "cpu")
    sites = torch.tensor([[0, 0], [7, 9], [3, 4]])
    assert torch.equal(ds_engine.probe_values(pair, sites),
                       stream_collide.probe_values(ds_engine.recombine(pair), sites))


@pytest.mark.parametrize("backend,shards", [("cuda", None), ("cuda-ds64", None),
                                            ("sharded-cuda", 2), ("sharded-cuda-rdma", 2),
                                            ("sharded-cuda-ds64", 2)])
def test_session_probes_never_copy_the_state(monkeypatch, backend, shards):
    """run_probed and probe_values on a session backend gather from the
    live buffers: Session.state() (a clone of the whole state) never runs."""
    _on_cpu(monkeypatch, backend, shards)
    cfg, _ = _pair(np.float64 if backend.endswith("ds64") else np.float32)
    sim = _sim(backend, cfg, _walls())
    want = _chunked(_sim(backend, cfg, _walls()), 4, 2)
    for cls in (fused_kernel.Session, fused_ds_kernel.Session, sharded.ShardedSession,
                sharded.ShardedRdmaSession, sharded.ShardedDSSession):
        monkeypatch.setattr(cls, "state", lambda self: pytest.fail("state() was called"))
    series = sim.run_probed(2, PROBES, every=2)
    last = sim.run(2).probe_values(PROBES)
    np.testing.assert_array_equal(np.concatenate([series, last[None]]), want)


def test_run_steps_probed_raises_off_a_card():
    """No fallback: the kernel's probed runner on a tensor that is neither
    on the CPU nor on a card raises, as its step does."""
    cfg, _ = _pair(np.float32)
    f = torch.empty((9, 24, 40), device="meta")
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        fused_kernel.run_steps_probed(f, _walls(), cfg, 2, PROBES)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            Simulation(cfg, _walls(), backend="cuda")
