"""bf16 storage in the port against the JAX package: the initial fill,
the plain engine (backend "torch") against JAX "xla", the kernel's plain
version against the JAX fused kernel in interpret mode, the facade, the
CLI, and a process where ml_dtypes cannot be imported.

The two JAX bf16 engines are different functions: "xla" rounds the
forced column to bf16 before the pull, the Pallas kernel keeps it
float32 through the pull. Each has its twin in the port, and each pair
is held bitwise. The bar is measured, not hoped for: on the 16x40
channel with a 4x3 block from a 5%-perturbed bf16 state, the twins
agree at every value after 10 steps (torch vs xla) and 3 steps
(step_reference vs pallas-interpret, T=1, which rounds every step as the
port does; the TPU planner's T=2 would not).
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu import Simulation as JaxSimulation
from latticeboltzmann_tpu.models.engine import initial_state as jax_initial_state
from latticeboltzmann_tpu.ops import fused_kernel as jfk
from latticeboltzmann_tpu.ops import stream_collide as jops
from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
from latticeboltzmann_tpu_torch.ops import stream_collide as ops
from latticeboltzmann_tpu_torch.utils import interop

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
BF16 = ml_dtypes.bfloat16


def _scene(**kw):
    """16x40 channel with a 4x3 block (tests/test_pallas.py:32-40's
    scene): (port cfg, JAX cfg, walls)."""
    walls = geometry.channel(16, 40)
    walls[5:9, 10:13] = True
    return (LatticeConfig(nx=16, ny=40, dtype="bfloat16", **kw),
            JaxConfig(nx=16, ny=40, dtype=jnp.bfloat16, **kw), walls)


def _perturbed_bits(cfg, seed=0):
    """Rest equilibrium times (1 + 5% uniform noise), rounded to bf16:
    the uint16 bits both packages start from."""
    rng = np.random.default_rng(seed)
    f = initial_state(cfg).astype(np.float64)
    f = (f * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, f.shape))).astype(np.float32)
    return f.astype(BF16).view(np.uint16)


def _jax_bits(x):
    return np.asarray(x).view(np.uint16)


def test_initial_state_bits_equal_jax():
    """bf16(bf16(density) * bf16(W[s])), rounded twice as the JAX
    package's numpy bf16 arithmetic: not the one-rounding bf16(density *
    W[s]) (at density 0.1 and W[1] = 1/9 the two differ)."""
    cfg, jcfg, _ = _scene()
    f = initial_state(cfg)
    assert f.dtype == np.float32
    t = torch.from_numpy(f).to(torch.bfloat16)
    assert np.array_equal(t.float().numpy(), f)  # the exact upcast of bf16 values
    np.testing.assert_array_equal(interop.to_bf16_bits(t), _jax_bits(jax_initial_state(jcfg)))
    assert f[1, 0, 0] == 0.01116943359375
    assert float(np.float32(0.1 / 9).astype(BF16)) == 0.0111083984375


def test_torch_engine_bitwise_jax_xla():
    cfg, jcfg, walls = _scene()
    bits = _perturbed_bits(cfg)
    f = interop.from_bf16_bits(bits, "cpu")
    out = ops.run_steps(f, torch.as_tensor(walls), cfg, 10)
    ref = jops.run_steps(jnp.asarray(bits.view(BF16)), jnp.asarray(walls), jcfg, 10)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(interop.to_bf16_bits(out), _jax_bits(ref))


def test_step_reference_bitwise_pallas_interpret():
    cfg, jcfg, walls = _scene()
    bits = _perturbed_bits(cfg)
    f = interop.from_bf16_bits(bits, "cpu")
    solid = torch.as_tensor(walls.astype(np.uint8))
    for _ in range(3):
        f = fk.step_reference(f, solid, cfg)
    ref = jfk.run_steps(jnp.asarray(bits.view(BF16)), jnp.asarray(walls), jcfg, 3,
                        interpret=True)
    assert f.dtype == torch.bfloat16
    np.testing.assert_array_equal(interop.to_bf16_bits(f), _jax_bits(ref))


def test_the_two_plain_versions_differ():
    """step_reference (the kernel's twin) and the torch engine (xla's
    twin) are different functions in bf16: the engine rounds the forced
    column before the pull. They agree away from the forced columns'
    neighbours after one step."""
    cfg, _, walls = _scene()
    f = interop.from_bf16_bits(_perturbed_bits(cfg), "cpu")
    a = fk.step_reference(f, torch.as_tensor(walls.astype(np.uint8)), cfg).float().numpy()
    b = ops.step(f, torch.as_tensor(walls), cfg).float().numpy()
    differ = np.argwhere(a != b)
    assert differ.size and set(differ[:, 2]) <= {0, 1, cfg.ny - 1}


@pytest.mark.parametrize("engine", ["torch", "step_reference"])
def test_bf16_tracks_f32(engine):
    """The JAX package's bf16 bar (tests/test_pallas.py:142-157): 10
    steps from rest track the float32 run within rtol 0.05, atol 2e-3."""
    cfg16, _, walls = _scene()
    cfg32 = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    out = {}
    for cfg in (cfg16, cfg32):
        f = interop.state_tensor(initial_state(cfg), cfg.dtype, "cpu")
        if engine == "torch":
            f = ops.run_steps(f, torch.as_tensor(walls), cfg, 10)
        else:
            f = fk.run_steps(f, walls, cfg, 10)
        out[cfg.dtype] = interop.to_numpy(f)
    assert np.isfinite(out["bfloat16"]).all() and (out["bfloat16"] >= 0).all()
    np.testing.assert_allclose(out["bfloat16"], out[np.float32], rtol=0.05, atol=2e-3)


def test_facade_bitwise_jax_xla_and_interop():
    """The facade with backend torch against the JAX facade with xla,
    the state carried across as bits: state() is float32, the exact
    upcast; moments and Re agree."""
    cfg, jcfg, walls = _scene()
    jsim = JaxSimulation(jcfg, walls, backend="xla").run(5)
    f, _, cfg2 = interop.from_numpy_state(jsim.state(), walls, dataclasses.asdict(jcfg), "cpu")
    assert f.dtype == torch.bfloat16
    np.testing.assert_array_equal(interop.to_bf16_bits(f), _jax_bits(jsim.state()))
    sim = Simulation(cfg2, walls, backend="torch", f0=jsim.state()).run(5)
    jsim.run(5)
    st = sim.state()
    assert st.dtype == np.float32
    np.testing.assert_array_equal(st, np.asarray(jsim.state(), np.float32))
    for a, b in zip(sim.macroscopic(), jsim.macroscopic()):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    np.testing.assert_array_equal(sim.speed_squared(),
                                  np.asarray(jsim.speed_squared(), np.float32))
    assert sim.reynolds() == pytest.approx(jsim.reynolds(), rel=1e-6)


def test_kernel_session_on_cpu_is_step_reference():
    """The bf16 Session on the CPU (the wrapper's plain path): plane and
    spec geometry give step_reference's bits."""
    cfg, _, walls = _scene()
    bits = _perturbed_bits(cfg)
    ref = interop.from_bf16_bits(bits, "cpu")
    solid = torch.as_tensor(walls.astype(np.uint8))
    for _ in range(4):
        ref = fk.step_reference(ref, solid, cfg)
    for spec in (None, geometry.infer_spec(walls)):
        sess = fk.Session(cfg, walls, device="cpu", wall_spec=spec)
        sess.load(interop.from_bf16_bits(bits, "cpu"))
        sess.advance(4)
        assert isinstance(sess.geom, tuple) == (spec is not None)
        assert torch.equal(sess.state(), ref)


@pytest.mark.parametrize("dtype", ["bfloat16", BF16, jnp.bfloat16, np.dtype(BF16),
                                   torch.bfloat16])
def test_storage_dtype_names_bf16(dtype):
    assert interop.storage_dtype(dtype) == torch.bfloat16
    assert interop.compute_dtype(dtype) == torch.float32
    assert interop.bytes_per_site(dtype) == 36


def test_bits_round_trip_and_refusals():
    bits = np.array([0x3C37, 0x0000, 0x8000, 0x7F80, 0x0001], dtype=np.uint16)
    t = interop.from_bf16_bits(bits, "cpu")
    np.testing.assert_array_equal(interop.to_bf16_bits(t), bits)
    with pytest.raises(ValueError):
        interop.from_bf16_bits(bits.astype(np.int32), "cpu")
    with pytest.raises(ValueError):
        interop.to_bf16_bits(torch.zeros(3))
    with pytest.raises(NotImplementedError):
        interop.storage_dtype(np.float16)


def test_cli_bf16_end_to_end():
    proc = subprocess.run(
        [sys.executable, "-m", "latticeboltzmann_tpu_torch", "--nx", "16", "--ny", "40",
         "--steps", "20", "--backend", "torch", "--precision", "bf16",
         "--print-stats-every", "10", "--warmup", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("Lattice Size: 16x40 (0.01 MB)")
    assert "backend=torch precision=bf16 device=cpu" in lines[0]
    cfg = LatticeConfig(nx=16, ny=40, dtype="bfloat16")
    sim = Simulation(cfg, geometry.build("barrier", 16, 40), backend="torch").run(20)
    assert float(lines[-2].split(" Re ")[1]) == pytest.approx(sim.reynolds(), rel=1e-9)


_NO_ML_DTYPES = r"""
import sys
sys.modules["ml_dtypes"] = None  # any import of ml_dtypes now raises
import numpy as np, torch
from latticeboltzmann_tpu_torch import LatticeConfig, geometry
from latticeboltzmann_tpu_torch.cli import main
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
from latticeboltzmann_tpu_torch.utils import stats
assert main(["--nx", "16", "--ny", "40", "--steps", "4", "--backend", "torch",
             "--precision", "bf16", "--print-stats-every", "2", "--warmup", "1"]) == 0
cfg = LatticeConfig(nx=16, ny=40, dtype="bfloat16")
walls = geometry.channel(16, 40)
sess = fk.Session(cfg, walls, device="cpu", wall_spec=geometry.infer_spec(walls))
sess.load(torch.from_numpy(initial_state(cfg)))
sess.advance(3)
out = sess.state()
assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
assert stats.RunStats(cfg, 10).itemsize == 2
assert "jax" not in sys.modules and "ml_dtypes" not in [
    m for m in sys.modules if sys.modules[m] is not None]
print("ok")
"""


def test_bf16_runs_without_ml_dtypes():
    """The card has no jax and no ml_dtypes: the bf16 CLI and a bf16
    Session run in a process where importing ml_dtypes fails."""
    proc = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "ok"
