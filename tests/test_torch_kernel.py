"""The stream-collide kernel's module (ops/fused_kernel.py): its plain
PyTorch version against the JAX fused Pallas kernel (interpret mode) and
the golden oracle, and the wrapper's refusals. tests/test_torch_cuda.py
holds the kernel itself against its plain version on a CUDA card.

Tolerances: 5e-7 after 3 steps is the JAX kernel's own bar against
golden (tests/test_pallas.py:32-40); float32 against the float64 oracle
and against another float32 association order cannot be tighter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu.models import golden
from latticeboltzmann_tpu.ops import fused_kernel as jfk
from latticeboltzmann_tpu_torch import LatticeConfig, geometry
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import cuda_build
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk

torch.set_num_threads(1)


def _barrier_16x40():
    """tests/test_pallas.py:32-40's scene: NY=40 is no multiple of 32."""
    walls = geometry.channel(16, 40)
    walls[5:9, 10:13] = True
    return LatticeConfig(nx=16, ny=40, dtype=np.float32), walls


def _column0_24x40():
    """A barrier on columns 0-2 with accel != 0: the forcing guard's wall
    term and the forced pulls into columns 1 and NY-1 both matter."""
    walls = geometry.channel(24, 40)
    walls[8:14, 0:3] = True
    return LatticeConfig(nx=24, ny=40, dtype=np.float32, accel=0.005), walls


def _golden64(cfg, walls, n, f0=None):
    jcfg = JaxConfig(nx=cfg.nx, ny=cfg.ny, tau=cfg.tau, csq=cfg.csq, accel=cfg.accel,
                     initial_density=cfg.initial_density, dtype=np.float64)
    f = golden.initial_state(jcfg) if f0 is None else np.asarray(f0, np.float64)
    return golden.run(f, walls, jcfg, n)


def _reference_run(cfg, walls, n, f0=None):
    """n steps of step_reference, the kernel's plain version."""
    f = torch.as_tensor(initial_state(cfg) if f0 is None else f0)
    solid = torch.as_tensor(walls.astype(np.uint8)) if walls.any() else None
    for _ in range(n):
        f = fk.step_reference(f, solid, cfg)
    return f.numpy()


@pytest.mark.parametrize("scene", [_barrier_16x40, _column0_24x40])
def test_step_reference_matches_pallas_interpret_and_golden(scene):
    cfg, walls = scene()
    out = _reference_run(cfg, walls, 3)
    jcfg = JaxConfig(nx=cfg.nx, ny=cfg.ny, accel=cfg.accel, dtype=np.float32)
    pallas = np.asarray(jfk.run_steps(
        jnp.asarray(initial_state(cfg)), jnp.asarray(walls), jcfg, 3, interpret=True
    ))
    assert out.shape == (9, cfg.nx, cfg.ny) and out.dtype == np.float32
    np.testing.assert_allclose(out, pallas, rtol=0, atol=5e-7)
    np.testing.assert_allclose(out, _golden64(cfg, walls, 3), rtol=0, atol=5e-7)


def test_column0_forcing_respects_walls():
    """Against an accel=0 step, forcing changed exactly the sites that
    pull a forced speed from a fluid site of column 0: the fluid rows of
    columns 1 and NY-1, and none of the rows whose three column-0
    sources (rows i-1, i, i+1) are all solid."""
    cfg, walls = _column0_24x40()
    forced = _reference_run(cfg, walls, 1)
    still = _reference_run(LatticeConfig(nx=24, ny=40, dtype=np.float32, accel=0.0), walls, 1)
    changed = forced != still
    for col in (1, 39):
        assert changed[:, 1:8, col].all() and changed[:, 14:23, col].all()
        assert not changed[:, 9:13, col].any()
    assert not changed[:, :, 0].any() and not changed[:, :, 2:39].any()


def test_packet_wraps_both_axes():
    """A +x+y packet at the far corner crosses both periodic edges in one
    collision-free step (tau huge), as tests/test_pallas.py:62-71."""
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32, tau=1e9, accel=0.0)
    walls = geometry.empty(cfg.nx, cfg.ny)
    f0 = initial_state(cfg)
    f0[5, cfg.nx - 1, cfg.ny - 1] += 1.0
    out = _reference_run(cfg, walls, 1, f0)
    assert out[5, 0, 0] > 1.0
    np.testing.assert_allclose(out, _golden64(cfg, walls, 1, f0), rtol=0, atol=5e-7)


def test_session_on_cpu_runs_the_reference():
    """The CPU wrapper path of a Session is step_reference, bit for bit,
    in both variants."""
    for cfg, walls in (_barrier_16x40(), (LatticeConfig(nx=16, ny=40, dtype=np.float32),
                                          geometry.empty(16, 40))):
        sess = fk.Session(cfg, walls, device="cpu")
        sess.load(torch.as_tensor(initial_state(cfg)))
        sess.advance(4)
        assert sess.has_walls == bool(walls.any())
        np.testing.assert_array_equal(sess.state().numpy(), _reference_run(cfg, walls, 4))
        np.testing.assert_array_equal(
            fk.run_steps(torch.as_tensor(initial_state(cfg)), walls, cfg, 4).numpy(),
            sess.unload().numpy(),
        )


def _refusal(case):
    cfg, walls = _barrier_16x40()
    src = torch.as_tensor(initial_state(cfg))
    dst = torch.empty_like(src)
    solid = torch.as_tensor(walls.astype(np.uint8))
    if case == "no_card":
        meta = src.to("meta")
        return RuntimeError, lambda: fk.step(meta, torch.empty_like(meta), None, cfg)
    if case == "src_is_dst":
        return ValueError, lambda: fk.step(src, src, solid, cfg)
    if case == "slip_code":
        # codes 2/3 are the slip classes; 4 is no class at all
        solid[3, 3] = 4
        return ValueError, lambda: fk.step(src, dst, solid, cfg)
    if case == "float64":
        return TypeError, lambda: fk.step(src.double(), dst.double(), solid, cfg)
    if case == "f64_config":
        cfg64 = LatticeConfig(nx=16, ny=40, dtype=np.float64)
        return NotImplementedError, lambda: fk.step(src, dst, solid, cfg64)
    if case == "shape":
        return ValueError, lambda: fk.step(src[:, :8].contiguous(), dst, solid, cfg)
    if case == "strided":
        return ValueError, lambda: fk.step(src.transpose(1, 2), dst, solid, cfg)
    if case == "no_solid":
        # a geometry that is neither None, a uint8 plane nor a spec tuple
        return ValueError, lambda: fk.step(src, dst, walls, cfg)
    if case == "long_spec":
        spec = (("channel",), ("rect", 5, 9, 10, 13), ("rect", 1, 2, 1, 2))
        return ValueError, lambda: fk.step(src, dst, spec, cfg)
    if case == "dtype_mismatch":
        return TypeError, lambda: fk.step(src, dst.to(torch.bfloat16), solid, cfg)
    raise AssertionError(case)


@pytest.mark.parametrize(
    "case",
    ["no_card", "src_is_dst", "slip_code", "float64", "f64_config", "shape",
     "strided", "no_solid", "long_spec", "dtype_mismatch"],
)
def test_wrapper_refuses(case):
    exc, call = _refusal(case)
    before = fk.LAUNCHES
    with pytest.raises(exc):
        call()
    assert fk.LAUNCHES == before


def test_solid_check_reruns_after_in_place_write():
    """A plane that passed is checked again after an in-place write: a
    slip code (3) is taken, a code past the classes (4) is refused."""
    cfg, walls = _barrier_16x40()
    src = torch.as_tensor(initial_state(cfg))
    dst = torch.empty_like(src)
    solid = torch.as_tensor(walls.astype(np.uint8))
    fk.step(src, dst, solid, cfg)
    solid[0, 0] = 3
    fk.step(src, dst, solid, cfg)
    solid[0, 0] = 4
    with pytest.raises(ValueError, match="codes 0-3"):
        fk.step(src, dst, solid, cfg)


def test_session_refuses_other_dtypes():
    """float32 and bf16 storage run; float16 and float64 raise, and so
    does a wall spec the kernel does not take."""
    for dtype in (np.float16, np.float64):
        with pytest.raises(NotImplementedError):
            fk.Session(LatticeConfig(nx=8, ny=8, dtype=dtype), geometry.empty(8, 8),
                       device="cpu")
    cfg, walls = _barrier_16x40()
    with pytest.raises(ValueError, match="at most one"):
        fk.Session(cfg, walls, device="cpu",
                   wall_spec=(("channel",), ("rect", 5, 9, 10, 13), ("rect", 1, 2, 1, 2)))


def test_kernel_constants_round_like_the_pallas_kernel():
    """The f32 launch constants are the JAX fused kernel's (ops/
    fused_kernel.py:424-434 and the folded products at :1041-1053)."""
    cfg = LatticeConfig(tau=0.6, csq=0.8, accel=0.01)
    f32 = np.float32
    itau = f32(1.0 / 0.6)
    expect = (f32(1.0) - itau, itau * f32(4 / 9), itau * f32(1 / 9), itau * f32(1 / 36),
              f32(3.0) * f32(1.0 / 0.8), f32(1.0 / 6.0) * f32(0.8), f32(0.5),
              f32(0.01) * f32(1 / 9), f32(0.01) * f32(1 / 36))
    assert fk.kernel_constants(cfg) == tuple(float(x) for x in expect)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No nvcc, or nvcc failing, raises: there is no fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho refused >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "build_dir", lambda: tmp_path / "out")
    with pytest.raises(RuntimeError, match="nvcc failed with code 3"):
        cuda_build.build()
    assert not (tmp_path / "out" / cuda_build.LIB_NAME).exists()
    assert "refused" in (tmp_path / "out" / "nvcc.log").read_text()
