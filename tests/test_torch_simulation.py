"""The port's slice end to end on the CPU: the Simulation facade against
the JAX package's, state carried across by utils/interop.py; the kernel
runner (Session and wrapper, on the CPU through step_reference) against
the JAX fused kernel's runner; the CLI; and the cuda backend's refusal
without a card."""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu import Simulation as JaxSimulation
from latticeboltzmann_tpu import geometry as jgeo
from latticeboltzmann_tpu.models.engine import initial_state as jax_initial_state
from latticeboltzmann_tpu.ops import fused_kernel as jfk
from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, available_backends, geometry
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
from latticeboltzmann_tpu_torch.utils import interop

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_scene(dtype):
    """The JAX suite's small scene (tests/conftest.py small_cfg/walls)."""
    cfg = JaxConfig(nx=24, ny=40, dtype=dtype)
    walls = jgeo.channel(cfg.nx, cfg.ny)
    walls[8:14, 10:13] = True
    return cfg, walls


# float64: the jitted JAX engine differs from eager ops by FMA contraction
# only (tests/test_xla_parity.py:53-60's bar); float32: the accumulation
# bar of tests/test_xla_parity.py:73
@pytest.mark.parametrize("dtype,rtol,atol", [(np.float64, 1e-13, 1e-18),
                                             (np.float32, 0, 5e-5)])
def test_simulation_torch_vs_jax_xla(dtype, rtol, atol):
    """20 steps in the JAX package, the state carried over through
    interop, 20 more steps in each package: the two states agree, and so
    do Re and the macroscopic fields."""
    jcfg, walls = _jax_scene(dtype)
    jsim = JaxSimulation(jcfg, walls, backend="xla").run(20)
    f, walls_t, cfg = interop.from_numpy_state(
        jsim.state(), jsim.walls_np, dataclasses.asdict(jcfg), "cpu"
    )
    assert cfg == LatticeConfig(**dataclasses.asdict(jcfg))
    assert torch.equal(walls_t, torch.as_tensor(walls))
    np.testing.assert_array_equal(interop.to_numpy(f), jsim.state())
    sim = Simulation(cfg, walls, backend="torch", f0=interop.to_numpy(f)).run(20)
    jsim.run(20)
    assert sim.steps_done == 20 and sim.elapsed > 0 and sim.mlups > 0
    np.testing.assert_allclose(sim.state(), jsim.state(), rtol=rtol, atol=atol)
    assert sim.reynolds() == pytest.approx(jsim.reynolds(), rel=1e-6 if dtype == np.float32 else 1e-12)
    for a, b in zip(sim.macroscopic(), jsim.macroscopic()):
        np.testing.assert_allclose(a, b, rtol=1e-4 if dtype == np.float32 else 1e-10, atol=1e-12)
    probes = np.array([[4, 5], [20, 30]])
    np.testing.assert_allclose(sim.probe_values(probes), jsim.probe_values(probes),
                               rtol=1e-4 if dtype == np.float32 else 1e-10, atol=1e-12)
    np.testing.assert_allclose(sim.speed_squared(), jsim.speed_squared(),
                               rtol=1e-3 if dtype == np.float32 else 1e-9, atol=1e-14)


def test_kernel_runner_vs_jax_pallas_runner():
    """The port's kernel runner (Session + wrapper, step_reference on the
    CPU) against the JAX fused kernel's runner in interpret mode, 3
    steps at tests/test_pallas.py:32-40's scene and bar."""
    jcfg = JaxConfig(nx=16, ny=40, dtype=np.float32)
    walls = jgeo.channel(jcfg.nx, jcfg.ny)
    walls[5:9, 10:13] = True
    ref = np.asarray(jfk.run_steps(
        jnp.asarray(jax_initial_state(jcfg)), jnp.asarray(walls), jcfg, 3, interpret=True
    ))
    f, _, cfg = interop.from_numpy_state(
        jax_initial_state(jcfg), walls, dataclasses.asdict(jcfg), "cpu"
    )
    out = interop.to_numpy(fk.run_steps(f, walls, cfg, 3))
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-7)


def test_interop_refuses_mismatches():
    jcfg, walls = _jax_scene(np.float32)
    st = jax_initial_state(jcfg)
    fields = dataclasses.asdict(jcfg)
    with pytest.raises(TypeError, match="bogus"):
        interop.from_numpy_state(st, walls, {**fields, "bogus": 1}, "cpu")
    with pytest.raises(ValueError, match="state shape"):
        interop.from_numpy_state(st[:, :8], walls, fields, "cpu")
    with pytest.raises(ValueError, match="walls shape"):
        interop.from_numpy_state(st, walls[:8], fields, "cpu")


def test_cli_end_to_end():
    proc = subprocess.run(
        [sys.executable, "-m", "latticeboltzmann_tpu_torch", "--nx", "24", "--ny", "40",
         "--steps", "20", "--backend", "torch", "--print-stats-every", "10"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("Lattice Size: 24x40") and "backend=torch precision=f32" in lines[0]
    assert sum("MLUPS:" in ln and "Elapsed" in ln for ln in lines) == 2
    assert lines[-2].startswith("Runtime: ") and " Re " in lines[-2]
    assert lines[-1].startswith("MLUPS: ")
    re_printed = float(lines[-2].split(" Re ")[1])
    cfg = LatticeConfig(nx=24, ny=40, dtype=np.float32)
    sim = Simulation(cfg, geometry.build("barrier", 24, 40), backend="torch").run(20)
    assert re_printed == pytest.approx(sim.reynolds(), rel=1e-9)


def test_auto_backend_and_cuda_refusal_without_card():
    from latticeboltzmann_tpu_torch.cli import resolve_backend

    assert available_backends() == ["cuda", "cuda-ds64", "sharded", "sharded-cuda",
                                    "sharded-cuda-ds64", "sharded-cuda-fused", "sharded-sync",
                                    "torch", "torch-ds64"]
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert resolve_backend("auto") == "torch"
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        Simulation(cfg, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        Simulation(cfg, backend="pallas")
