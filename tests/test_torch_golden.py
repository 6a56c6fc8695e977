"""The port's golden oracle (latticeboltzmann_tpu_torch/models/golden.py)
against the JAX package's: every one of its nine functions bitwise equal
(np.testing.assert_array_equal) on the same numpy inputs, made from a
seed, on an empty box, a channel and a channel with a barrier that
reaches column 0 (24x40), with free-slip masks where a function takes
them; reynolds also on a float64 state of the cuda-ds64 backend's CPU
twin (its kernel session through the plain versions). The module imports
neither jax nor the JAX package, and the port's facade exports it as the
JAX facade does."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import latticeboltzmann_tpu.models as jmodels
from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu.models import golden as jgolden
from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch import models as tmodels
from latticeboltzmann_tpu_torch.models import engine
from latticeboltzmann_tpu_torch.models import golden

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
NX, NY = 24, 40
SCENES = ["empty", "channel", "barrier"]
SLIPS = ["none", "x", "y", "both"]


def _walls(name):
    if name == "empty":
        return geometry.empty(NX, NY)
    if name == "channel":
        return geometry.channel(NX, NY)
    # the plate at column 0, where the forcing reads the walls
    return geometry.channel_with_barrier(NX, NY, barrier_rows=(8, 14), barrier_cols=(0, 3))


def _configs(dtype=np.float64, **kw):
    """The same fields as the port's and the JAX package's LatticeConfig."""
    cfg = LatticeConfig(nx=NX, ny=NY, dtype=dtype, **kw)
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    return cfg, jcfg


def _state(cfg, seed=0):
    """Rest equilibrium times (1 + 5% noise), with the forcing guard
    failing at one column-0 site."""
    rng = np.random.default_rng(seed)
    f = golden.initial_state(cfg) * (1 + 0.05 * rng.uniform(-1, 1, (9, cfg.nx, cfg.ny)))
    f[6, cfg.nx // 2, 0] = 1e-6
    return f


def _slips(kind, seed=1):
    """Free-slip masks that overlap the walls in places (the precedence
    walls > slip_x > slip_y is then exercised)."""
    rng = np.random.default_rng(seed)
    sx = rng.uniform(size=(NX, NY)) < 0.08
    sy = rng.uniform(size=(NX, NY)) < 0.08
    return {"none": (None, None), "x": (sx, None), "y": (None, sy), "both": (sx, sy)}[kind]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_initial_state_equal(dtype):
    cfg, jcfg = _configs(initial_density=0.3)
    got, want = golden.initial_state(cfg, dtype), jgolden.initial_state(jcfg, dtype)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scene", SCENES)
def test_apply_source_equal(scene):
    cfg, jcfg = _configs()
    f, walls = _state(cfg), _walls(scene)
    got = golden.apply_source(f, walls, cfg)
    np.testing.assert_array_equal(got, jgolden.apply_source(f, walls, jcfg))
    assert not np.array_equal(got, f)  # the forcing ran somewhere


@pytest.mark.parametrize("scene", SCENES)
def test_pull_and_collide_equal(scene):
    cfg, jcfg = _configs(tau=0.6, accel=0.01)
    f = _state(cfg, seed=SCENES.index(scene))
    pulled = golden.pull(f)
    np.testing.assert_array_equal(pulled, jgolden.pull(f))
    np.testing.assert_array_equal(golden.collide(pulled, cfg), jgolden.collide(pulled, jcfg))


@pytest.mark.parametrize("slip", SLIPS)
@pytest.mark.parametrize("scene", SCENES)
def test_stream_collide_and_step_equal(scene, slip):
    cfg, jcfg = _configs()
    f, walls = _state(cfg), _walls(scene)
    sx, sy = _slips(slip)
    np.testing.assert_array_equal(golden.stream_collide(f, walls, cfg, sx, sy),
                                  jgolden.stream_collide(f, walls, jcfg, sx, sy))
    np.testing.assert_array_equal(golden.step(f, walls, cfg, sx, sy),
                                  jgolden.step(f, walls, jcfg, sx, sy))


@pytest.mark.parametrize("slip", SLIPS)
@pytest.mark.parametrize("scene", SCENES)
def test_run_equal(scene, slip):
    cfg, jcfg = _configs()
    f, walls = _state(cfg), _walls(scene)
    sx, sy = _slips(slip)
    got = golden.run(f, walls, cfg, 6, sx, sy)
    np.testing.assert_array_equal(got, jgolden.run(f, walls, jcfg, 6, sx, sy))
    np.testing.assert_array_equal(golden.run(f, walls, cfg, 0), f)


@pytest.mark.parametrize("scene", SCENES)
def test_macroscopic_and_reynolds_equal(scene):
    cfg, jcfg = _configs()
    walls = _walls(scene)
    f = golden.run(_state(cfg), walls, cfg, 4)
    for a, b in zip(golden.macroscopic(f), jgolden.macroscopic(f)):
        np.testing.assert_array_equal(a, b)
    re = golden.reynolds(f, walls, cfg)
    assert isinstance(re, float) and np.isfinite(re)
    assert re == jgolden.reynolds(f, walls, jcfg)


def test_reynolds_equal_on_a_cuda_ds64_state(monkeypatch):
    """A float64 state of cuda-ds64's CPU twin (the ds kernel session
    through its plain versions) on a lattice tall enough (64 rows) that a
    device reduction adds in another order: the port's golden.reynolds ==
    the JAX golden's == the facade's reynolds()."""
    monkeypatch.setattr(engine, "_KERNEL_BACKENDS", set())  # on the CPU, for the test
    cfg = LatticeConfig(nx=64, ny=40, dtype=np.float64)
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    walls = geometry.channel(64, 40)
    walls[20:30, 10:13] = True
    rng = np.random.default_rng(3)
    f0 = golden.initial_state(cfg) * (1 + 0.05 * rng.uniform(-1, 1, (9, 64, 40)))
    sim = Simulation(cfg, walls, backend="cuda-ds64", device="cpu", f0=f0).run(8)
    st = sim.state()
    assert st.dtype == np.float64
    re = golden.reynolds(st, walls, cfg)
    assert re == jgolden.reynolds(st, walls, jcfg)
    assert re == sim.reynolds()


def test_module_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((REPO / "latticeboltzmann_tpu_torch/models/golden.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    assert names and all(n.split(".")[0] not in ("jax", "latticeboltzmann_tpu", "torch")
                         for n in names), names
    assert {"numpy", "..core.spec"} <= set(names)


def test_exported_as_the_jax_facade_exports_it():
    assert tmodels.golden is golden
    assert "golden" in tmodels.__all__
    assert sorted(tmodels.__all__) == sorted(jmodels.__all__)
    public = sorted(n for n, v in vars(jgolden).items()
                    if callable(v) and getattr(v, "__module__", None) == jgolden.__name__)
    assert public == sorted(["initial_state", "apply_source", "pull", "collide",
                             "stream_collide", "step", "run", "macroscopic", "reynolds"])
    for name in public:
        assert getattr(golden, name).__module__ == golden.__name__
