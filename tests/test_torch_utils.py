"""The port's utils (native IO, snapshots and the movie, raw checkpoints,
the profiler) against the JAX package's, on the same seeded inputs: the
twin of tests/test_utils.py's utils tests.

Bars: bitwise throughout. The snapshot CSV and the raw files are bytes,
and either package's writer, and either path of the port's CSV writer
(the C++ library, NumPy), must write the same ones. speed_squared runs the same
binary ops in the same association in both packages (float64 and
float32 alike; IEEE division on both sides). A resumed run continues
bit for bit (the state is Markov), and float64 eager PyTorch is bitwise
equal to golden and so to the JAX xla engine (tests/test_torch_engine.py).
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu import Simulation as JaxSimulation
from latticeboltzmann_tpu.models import golden
from latticeboltzmann_tpu.utils import checkpoint as jckpt
from latticeboltzmann_tpu.utils import native as jnative
from latticeboltzmann_tpu.utils import viz as jviz
from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.utils import checkpoint, native, profiler, viz
from latticeboltzmann_tpu_torch.utils.interop import storage_dtype, to_bf16_bits

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
NX, NY = 24, 40


def _walls():
    """conftest's small_walls (a channel with an interior barrier)."""
    w = geometry.channel(NX, NY)
    w[8:14, 10:13] = True
    return w


def _configs(dtype):
    """(port cfg, JAX cfg) of the 24x40 lattice; bf16 is the string
    "bfloat16" in the port and the ml_dtypes type in the JAX package."""
    jdtype = np.dtype("bfloat16").type if dtype == "bfloat16" else dtype
    return LatticeConfig(nx=NX, ny=NY, dtype=dtype), JaxConfig(nx=NX, ny=NY, dtype=jdtype)


def _developed(dtype=np.float64, steps=12):
    """A golden state after a few steps, perturbed by seeded noise so every
    site moves, in `dtype`."""
    _, jcfg = _configs(np.float64)
    f = golden.run(golden.initial_state(jcfg), _walls(), jcfg, steps)
    rng = np.random.default_rng(0)
    return (f * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, f.shape))).astype(dtype)


def _same_config(cfg, jcfg):
    """Every field equal; the dtype by its storage name (bf16 is named
    differently in the two packages)."""
    for name in ("nx", "ny", "tau", "csq", "accel", "initial_density", "wraparound"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert storage_dtype(cfg.dtype) == storage_dtype(jcfg.dtype)


# --- native ----------------------------------------------------------------


def test_native_source_is_a_byte_copy():
    src = (REPO / "latticeboltzmann_tpu_torch" / "native" / "lbm_io.cpp").read_bytes()
    assert src == (REPO / "latticeboltzmann_tpu" / "native" / "lbm_io.cpp").read_bytes()


def test_native_builds_outside_the_source_tree():
    assert native.available()
    so = native.library_path()
    assert so.is_file() and so.parent.parent.parent == REPO / "build"
    assert not list((REPO / "latticeboltzmann_tpu_torch" / "native").glob("*.so"))
    with native.numpy_only():
        assert not native.available()
    assert native.available()


def test_csv_bytes_equal_across_packages_and_paths(tmp_path):
    """The same float64 array through JAX's writer, the port's C++ path and
    its NumPy path: the same bytes, the reference's '%.10f' and ', '."""
    data = np.random.default_rng(1).normal(scale=1e-3, size=(NX, NY))
    data[0, :4] = [0.0, -0.0, 1.5, 123.456789012345]
    jnative.write_csv(str(tmp_path / "jax.csv"), data)
    native.write_csv(str(tmp_path / "native.csv"), data)
    with native.numpy_only():
        native.write_csv(str(tmp_path / "numpy.csv"), data)
        viz.write_snapshot_csv(tmp_path / "viz_numpy.csv", data)
    viz.write_snapshot_csv(tmp_path / "viz.csv", data)
    jviz.write_snapshot_csv(tmp_path / "jviz.csv", data)
    want = (tmp_path / "jax.csv").read_bytes()
    for name in ("native", "numpy", "viz_numpy", "viz", "jviz"):
        assert (tmp_path / f"{name}.csv").read_bytes() == want, name
    first = want.decode().splitlines()[0]
    assert first == ", ".join(f"{v:.10f}" for v in data[0])


@pytest.mark.parametrize("port_writes", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint16])
def test_raw_round_trips(tmp_path, dtype, port_writes):
    """Raw files of float32, float64 and uint16 (bf16 bits) written by
    either package read back bitwise by both."""
    rng = np.random.default_rng(2)
    x = (rng.integers(0, 2**16, size=(9, 8, 16)) if dtype == np.uint16
         else rng.normal(size=(9, 8, 16))).astype(dtype)
    path = str(tmp_path / "x.raw")
    (native if port_writes else jnative).write_raw(path, x)
    for reader in (native, jnative):
        y = reader.read_raw(path, x.shape, dtype)
        assert y.dtype == x.dtype
        np.testing.assert_array_equal(y, x)


# --- viz -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_speed_squared_bitwise_jax(dtype):
    f = _developed(dtype)
    got = viz.speed_squared(torch.as_tensor(f))
    assert got.dtype == storage_dtype(dtype) and got.shape == (NX, NY)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jviz.speed_squared(f)))


def test_speed_squared_matches_golden_and_the_facade():
    cfg, jcfg = _configs(np.float64)
    sim = Simulation(cfg, _walls(), backend="torch").run(10)
    usq = viz.speed_squared(sim.f).numpy()
    _, ux, uy = golden.macroscopic(golden.run(golden.initial_state(jcfg), _walls(), jcfg, 10))
    np.testing.assert_array_equal(usq, ux * ux + uy * uy)
    np.testing.assert_array_equal(usq, sim.speed_squared())


def test_snapshot_round_trip_and_bytes_equal_jax(tmp_path):
    f = _developed()
    path = viz.save_snapshot(tmp_path / "port", 4, torch.as_tensor(f))
    assert path.name == "4.csv"
    grid = np.loadtxt(path, delimiter=",")
    assert grid.shape == (NX, NY) and np.isfinite(grid).all()
    np.testing.assert_allclose(grid, viz.speed_squared(torch.as_tensor(f)).numpy(), atol=5e-11)
    assert path.read_bytes() == jviz.save_snapshot(tmp_path / "jax", 4, f).read_bytes()


def test_render_frame_and_movie(tmp_path):
    cfg, _ = _configs(np.float64)
    sim = Simulation(cfg, _walls(), backend="torch")
    for n in (2, 4):
        sim.run(2)
        viz.save_snapshot(tmp_path / "data", n, sim.f)
    viz.render_frame(sim.speed_squared(), tmp_path / "frame.png")
    assert (tmp_path / "frame.png").stat().st_size > 0
    out = viz.render_movie(tmp_path / "data", tmp_path / "flow.gif", fps=2)
    assert out.exists() and out.stat().st_size > 0
    with pytest.raises(FileNotFoundError):
        viz.render_movie(tmp_path / "nothing", tmp_path / "none.gif")


# --- checkpoint ------------------------------------------------------------


def _bits_or_array(f):
    """A state as comparable host bits: a bf16 array (ml_dtypes, from the
    JAX package) as uint16, any other as it is."""
    f = np.asarray(f)
    return f.view(np.uint16) if f.dtype.name == "bfloat16" else f


@pytest.mark.parametrize("dtype", [np.float32, np.float64, "bfloat16"])
def test_port_checkpoint_read_by_jax(tmp_path, dtype):
    cfg, jcfg = _configs(dtype)
    sim = Simulation(cfg, _walls(), backend="torch").run(6)
    d = checkpoint.save(tmp_path, 6, sim.state(), sim.walls_np, cfg)
    assert d.name == "6.lbmckpt"
    meta = json.loads((d / "meta.json").read_text())
    assert meta["dtype"] == {np.float32: "float32", np.float64: "float64"}.get(dtype, dtype)
    step, f, walls, jcfg_loaded = jckpt.load(d)
    assert step == 6 and jcfg_loaded == jcfg
    np.testing.assert_array_equal(walls, _walls())
    want = to_bf16_bits(sim.f) if dtype == "bfloat16" else sim.state()
    np.testing.assert_array_equal(_bits_or_array(f), want)
    assert _bits_or_array(f).dtype == want.dtype


@pytest.mark.parametrize("dtype", [np.float32, np.float64, "bfloat16"])
def test_jax_checkpoint_read_by_the_port(tmp_path, dtype):
    cfg, jcfg = _configs(dtype)
    jsim = JaxSimulation(jcfg, _walls(), backend="xla").run(6)
    d = jckpt.save(tmp_path, 6, jsim.state(), jsim.walls_np, jcfg)
    step, f, walls, cfg_loaded = checkpoint.load(d)
    assert step == 6 and cfg_loaded == cfg
    _same_config(cfg_loaded, jcfg)
    np.testing.assert_array_equal(walls, _walls())
    if dtype == "bfloat16":
        # float32 holding the exact bf16 values: their bits are the file's
        assert f.dtype == np.float32
        bits = to_bf16_bits(torch.from_numpy(f).to(torch.bfloat16))
        np.testing.assert_array_equal(bits, np.asarray(jsim.state()).view(np.uint16))
        np.testing.assert_array_equal(f, np.asarray(jsim.state(), np.float32))
    else:
        assert f.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(f, jsim.state())


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16", np.float64])
def test_checkpoint_resume_bitwise(tmp_path, dtype):
    """run 20 == run 10 + save/load + run 10 (tests/test_utils.py:59-68)."""
    cfg, _ = _configs(dtype)
    full = Simulation(cfg, _walls(), backend="torch").run(20).state()
    first = Simulation(cfg, _walls(), backend="torch").run(10)
    d = checkpoint.save(tmp_path, 10, first.state(), first.walls_np, cfg)
    step, f0, walls, cfg_loaded = checkpoint.load(d)
    assert step == 10 and cfg_loaded == cfg
    resumed = Simulation(cfg_loaded, walls, backend="torch", f0=f0).run(10).state()
    np.testing.assert_array_equal(resumed, full)


def test_jax_checkpoint_resumes_in_the_port_as_in_jax(tmp_path):
    """A JAX checkpoint (xla, float64) resumed by the port's float64 engine
    continues bitwise to the JAX package's own resume."""
    _, jcfg = _configs(np.float64)
    first = JaxSimulation(jcfg, _walls(), backend="xla").run(10)
    d = jckpt.save(tmp_path, 10, first.state(), first.walls_np, jcfg)
    _, jf0, jwalls, jcfg_loaded = jckpt.load(d)
    want = JaxSimulation(jcfg_loaded, jwalls, backend="xla", f0=jf0).run(10).state()
    _, f0, walls, cfg = checkpoint.load(d)
    got = Simulation(cfg, walls, backend="torch", f0=f0).run(10).state()
    np.testing.assert_array_equal(got, want)


def test_checkpoint_latest(tmp_path):
    cfg, _ = _configs(np.float64)
    f = initial_state(cfg)
    checkpoint.save(tmp_path, 5, f, _walls(), cfg)
    checkpoint.save(tmp_path, 15, f, _walls(), cfg)
    assert checkpoint.latest(tmp_path).name == "15.lbmckpt"
    assert checkpoint.latest(tmp_path / "nope") is None


def test_checkpoint_orbax_and_bad_inputs_raise(tmp_path):
    cfg, jcfg = _configs(np.float64)
    f = initial_state(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        checkpoint.save(tmp_path, 1, f, _walls(), cfg, format="orbax")
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        checkpoint.save(tmp_path, 1, f, _walls(), cfg, format="bogus")
    # a float32 state under a float64 config would be misnamed in the meta
    with pytest.raises(ValueError, match="float64"):
        checkpoint.save(tmp_path, 1, f.astype(np.float32), _walls(), cfg)
    # a JAX orbax checkpoint is found by latest() and refused by load()
    d = jckpt.save(tmp_path, 7, golden.initial_state(jcfg), _walls(), jcfg, format="orbax")
    assert checkpoint.latest(tmp_path) == d
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        checkpoint.load(d)
    assert not list(tmp_path.glob("1.*"))


def test_checkpoint_takes_tensors_on_any_device(tmp_path):
    """A bf16 tensor's bits, a float32 tensor and a tensor mask save as the
    host arrays do."""
    for dtype in (np.float32, "bfloat16"):
        cfg, _ = _configs(dtype)
        sim = Simulation(cfg, _walls(), backend="torch").run(3)
        a = checkpoint.save(tmp_path / "tensor", 3, sim.f, sim.walls, cfg)
        b = checkpoint.save(tmp_path / "array", 3, sim.state(), sim.walls_np, cfg)
        for name in ("f.raw", "walls.raw", "meta.json"):
            assert (a / name).read_bytes() == (b / name).read_bytes(), (dtype, name)


_BF16_WITHOUT_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None  # any import of ml_dtypes now raises
import numpy as np
from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.utils import checkpoint
from latticeboltzmann_tpu_torch.utils.interop import to_bf16_bits
cfg = LatticeConfig(nx=16, ny=40, dtype="bfloat16")
walls = geometry.channel(16, 40)
full = Simulation(cfg, walls, backend="torch").run(8)
first = Simulation(cfg, walls, backend="torch").run(4)
d = checkpoint.save(sys.argv[1], 4, first.state(), walls, cfg)
step, f0, w, cfg2 = checkpoint.load(d)
assert step == 4 and cfg2 == cfg and f0.dtype == np.float32
resumed = Simulation(cfg2, w, backend="torch", f0=f0).run(4)
assert (to_bf16_bits(resumed.f) == to_bf16_bits(full.f)).all()
assert "jax" not in sys.modules and "ml_dtypes" not in [
    m for m in sys.modules if sys.modules[m] is not None]
print("ok")
"""


def test_bf16_checkpoint_without_ml_dtypes(tmp_path):
    """The card's machine has no ml_dtypes: a bf16 checkpoint saves,
    loads and resumes bitwise in a process where importing it fails."""
    proc = subprocess.run([sys.executable, "-c", _BF16_WITHOUT_ML_DTYPES, str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "ok"


# --- profiler --------------------------------------------------------------


def test_profiler_steptimer_and_trace(tmp_path):
    t = profiler.StepTimer()
    time.sleep(0.01)
    lap = t.lap()
    assert 0 < lap <= t.elapsed + 1e-6 and t.laps == [lap]
    with profiler.trace(str(tmp_path / "trace")):
        with profiler.annotate("lbm-step"):
            float(torch.ones(8, 8).sum())
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "lbm-step" for e in events)
