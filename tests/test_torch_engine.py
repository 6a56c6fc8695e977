"""The port's portable engine (ops/stream_collide.py) against the golden
oracle and the JAX engine it twins.

Eager float64 PyTorch runs the reference's association order with plain
binary ops, so it is bitwise-equal to golden (the JAX engine's own bar,
tests/test_xla_parity.py:27-53). Inputs are numpy arrays with explicit
dtypes: the test process runs jax with x64 enabled.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu import Simulation as JaxSimulation
from latticeboltzmann_tpu.models import golden
from latticeboltzmann_tpu.ops import stream_collide as jops
from latticeboltzmann_tpu_torch import LatticeConfig, geometry
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import stream_collide as ops

torch.set_num_threads(1)


def _scene(dtype=np.float64, **kw):
    """The JAX suite's small scene (tests/conftest.py): 24x40 channel
    with an interior barrier; (port cfg, JAX cfg, walls)."""
    cfg = LatticeConfig(nx=24, ny=40, dtype=dtype, **kw)
    walls = geometry.channel(cfg.nx, cfg.ny)
    walls[8:14, 10:13] = True
    return cfg, JaxConfig(nx=24, ny=40, dtype=dtype, **kw), walls


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


@pytest.mark.parametrize("slip", [False, True])
def test_f64_step_bitwise_golden(slip):
    """Five eager float64 steps equal golden bit for bit, with and
    without free-slip sites (channel rows as slip_x)."""
    cfg, jcfg, walls = _scene()
    slip_x = None
    if slip:
        slip_x = geometry.channel(cfg.nx, cfg.ny)
        walls = walls & ~slip_x
    g = golden.initial_state(jcfg)
    f = _t(g)
    for _ in range(5):
        g = golden.step(g, walls, jcfg, slip_x)
        f = ops.step(f, _t(walls), cfg, None if slip_x is None else _t(slip_x))
    np.testing.assert_array_equal(f.numpy(), g)


def test_f64_substeps_bitwise_golden():
    cfg, jcfg, walls = _scene()
    g0 = golden.initial_state(jcfg)
    g1 = golden.apply_source(g0, walls, jcfg)
    np.testing.assert_array_equal(ops.apply_source(_t(g0), _t(walls), cfg).numpy(), g1)
    gp = golden.pull(g1)
    np.testing.assert_array_equal(ops.pull(_t(g1)).numpy(), gp)
    gc = golden.collide(gp, jcfg)
    np.testing.assert_array_equal(ops.collide(_t(gp), cfg).numpy(), gc)


def test_forcing_guard_engages_bitwise():
    """A huge accel makes the all-or-nothing guard freeze column 0
    (src/latticeboltzmann.c:500-513), as in golden."""
    cfg = LatticeConfig(nx=10, ny=12, dtype=np.float64, accel=10.0)
    jcfg = JaxConfig(nx=10, ny=12, dtype=np.float64, accel=10.0)
    walls = geometry.channel(cfg.nx, cfg.ny)
    f0 = golden.initial_state(jcfg)
    out = ops.apply_source(_t(f0), _t(walls), cfg).numpy()
    np.testing.assert_array_equal(out, golden.apply_source(f0, walls, jcfg))
    np.testing.assert_array_equal(out, f0)


def test_f32_run_steps_tracks_jax_xla():
    """50 float32 steps: the port's engine and the JAX xla engine stay
    within 5e-5 (the xla engine's own f32 bar, tests/test_xla_parity.py:73)."""
    cfg, jcfg, walls = _scene(np.float32)
    out = ops.run_steps(_t(initial_state(cfg)), _t(walls), cfg, 50).numpy()
    ref = JaxSimulation(jcfg, walls, backend="xla").run(50).state()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-5)


def test_moments_equal_jax():
    """macroscopic and probe_values are elementwise: bitwise-equal to the
    JAX functions on the same float64 state. reynolds sums a column,
    and the two reductions may associate differently: rtol 1e-13."""
    cfg, jcfg, walls = _scene()
    st = golden.run(golden.initial_state(jcfg), walls, jcfg, 20)
    f, fj = _t(st), jnp.asarray(st)
    for a, b in zip(ops.macroscopic(f), jops.macroscopic(fj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    probes = np.array([[3, 0], [12, 20], [23, 39], [5, 11]], dtype=np.int32)
    np.testing.assert_array_equal(
        ops.probe_values(f, probes).numpy(),
        np.asarray(jops.probe_values(fj, jnp.asarray(probes))),
    )
    for col in (None, 1, 25):
        re_t = float(ops.reynolds(f, _t(walls), cfg, col))
        re_j = float(jops.reynolds(fj, jnp.asarray(walls), jcfg, col))
        np.testing.assert_allclose(re_t, re_j, rtol=1e-13)
    assert float(ops.reynolds(f, _t(walls), cfg)) == pytest.approx(
        golden.reynolds(st, walls, jcfg), rel=1e-13
    )


def test_reductions_accumulate_in_f32_at_least():
    cfg, _, walls = _scene(np.float32)
    f = _t(initial_state(cfg))
    assert ops.reynolds(f, _t(walls), cfg).dtype == torch.float32
    assert ops.probe_moments(f[:, 0, :3].to(torch.bfloat16)).dtype == torch.float32


def test_unsupported_dtype_raises():
    """float32, float64 and bf16 storage are taken; float16 is not."""
    cfg = LatticeConfig(nx=8, ny=8, dtype=np.float16)
    f = torch.zeros((9, 8, 8))
    with pytest.raises(NotImplementedError, match="float16"):
        ops.collide(f, cfg)
