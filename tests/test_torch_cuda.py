"""The port's CUDA kernels on a CUDA card, against their plain PyTorch
versions; the tests skip without a card (a kernel has no CPU mode).

This file imports neither jax nor the JAX package, so it also runs where
only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

The kernels are built with -fmad=false and IEEE division (the ds kernel
writes every op as an _rn intrinsic) and round like their step_reference:
the bar is bitwise equality, for float32 and bf16 storage and for every
geometry source (none, class plane with slip codes, wall spec). The
fast-math variant has no bitwise reference and is held to IEEE 1/rho
within fused_kernel.FAST_MATH_RTOL. The facade's cuda backend against its
torch backend uses the JAX package's pallas-vs-xla bar (rtol 1e-4, atol
1e-7 after 20 steps, tests/test_pallas.py:74-81): the two engines
associate the collision differently; in bf16 the JAX package's bf16 bar
(rtol 0.05, atol 2e-3, tests/test_pallas.py:142-157), since the XLA twin
also rounds the forced column before the pull. The cuda-ds64 backend
against the float64 torch backend uses the JAX package's pair-DP bar,
1e-11 relative (tests/test_ds.py:213-229).
"""

import numpy as np
import pytest
import torch

from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import df64
from latticeboltzmann_tpu_torch.ops import fused_ds_kernel as fdk
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
from latticeboltzmann_tpu_torch.utils.interop import state_tensor

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _scene(name, dtype=np.float32):
    if name == "barrier":
        walls = geometry.channel(16, 40)
        walls[5:9, 10:13] = True
        return LatticeConfig(nx=16, ny=40, dtype=dtype), walls
    if name == "column0":
        walls = geometry.channel(24, 40)
        walls[8:14, 0:3] = True
        return LatticeConfig(nx=24, ny=40, dtype=dtype, accel=0.005), walls
    return LatticeConfig(nx=16, ny=40, dtype=dtype), geometry.empty(16, 40)


def _plate_48x96():
    """Channel walls and a 20x5 plate: a channel + rect wall spec."""
    walls = geometry.channel(48, 96)
    walls[10:30, 20:25] = True
    return walls


def _slip_scene(nx, ny):
    """A channel whose top wall row is slip_x, with a slip_y block:
    (walls, slip_x, slip_y), every class code 0-3 present."""
    walls = geometry.channel(nx, ny)
    slip_x = np.zeros_like(walls)
    slip_x[0] = True
    walls[0] = False
    slip_y = np.zeros_like(walls)
    slip_y[nx // 3: nx // 3 + 2, ny // 8: ny // 8 + 2] = True
    return walls, slip_x, slip_y


def _perturbed(cfg, device, seed=0):
    rng = np.random.default_rng(seed)
    f0 = initial_state(cfg) * (1 + 0.05 * rng.uniform(-1, 1, (9, cfg.nx, cfg.ny)))
    return state_tensor(f0.astype(np.float32), cfg.dtype, device)


def _reference(src, geom, cfg):
    if isinstance(geom, tuple):
        return fk.step_reference(src, None, cfg, wall_spec=geom)
    return fk.step_reference(src, geom, cfg)


def _bitwise_steps(cfg, geom, device, steps=10):
    """`steps` kernel launches, each held bitwise against step_reference
    from the same input."""
    a = _perturbed(cfg, device)
    b = torch.empty_like(a)
    before = fk.LAUNCHES
    for _ in range(steps):
        fk.step(a, b, geom, cfg)
        ref = _reference(a, geom, cfg)
        torch.cuda.synchronize()
        assert torch.equal(b, ref)
        a, b = b, a
    assert fk.LAUNCHES == before + steps


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("name", ["barrier", "column0", "empty"])
def test_kernel_equals_step_reference(name, dtype, cuda_device):
    """Plane and wall-free variants, float32 and bf16 storage."""
    cfg, walls = _scene(name, dtype)
    _bitwise_steps(cfg, torch.as_tensor(walls.astype(np.uint8), device=cuda_device),
                   cuda_device)
    _bitwise_steps(cfg, None, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_spec_and_slip_variants_equal_step_reference(dtype, cuda_device):
    """The spec variant at a channel+rect and a channel+circle scene, and
    the slip codes on a channel whose top row is slip_x with a slip_y
    block."""
    cfg = LatticeConfig(nx=48, ny=96, dtype=dtype)
    for walls in (_plate_48x96(), geometry.channel_with_cylinder(48, 96)):
        spec = geometry.infer_spec(walls)
        assert spec is not None
        _bitwise_steps(cfg, spec, cuda_device)
    walls, slip_x, slip_y = _slip_scene(48, 96)
    cls = torch.as_tensor(fk.class_plane(walls, slip_x, slip_y), device=cuda_device)
    assert set(torch.unique(cls).tolist()) == {0, 1, 2, 3}
    _bitwise_steps(cfg, cls, cuda_device)


@pytest.mark.cuda
def test_fast_math_within_its_tolerance(cuda_device):
    cfg = LatticeConfig(nx=48, ny=96, dtype=np.float32)
    spec = geometry.infer_spec(_plate_48x96())
    a = _perturbed(cfg, cuda_device)
    ref, b = a.clone(), torch.empty_like(a)
    for _ in range(fk.FAST_MATH_STEPS):
        fk.step(a, b, spec, cfg, fast_math=True)
        a, b = b, a
        ref = fk.step_reference(ref, None, cfg, wall_spec=spec, fast_math=True)
    assert float(((a - ref).abs() / ref.abs()).max()) <= fk.FAST_MATH_RTOL


@pytest.mark.cuda
def test_cuda_backend_tracks_torch_backend(cuda_device):
    cfg, walls = _scene("column0")  # channel + rect: the spec variant
    before = fk.VARIANT_LAUNCHES["f32-spec"]
    out = Simulation(cfg, walls, backend="cuda").run(20).state()
    assert fk.VARIANT_LAUNCHES["f32-spec"] == before + 20
    ref = Simulation(cfg, walls, backend="torch", device=cuda_device).run(20).state()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-7)
    with pytest.raises(NotImplementedError, match="ROADMAP B15"):
        Simulation(LatticeConfig(nx=16, ny=40, dtype=np.float64), walls[:16],
                   backend="cuda")


@pytest.mark.cuda
def test_cuda_bf16_and_slip_track_torch_backend(cuda_device):
    """bf16 through the facade (the spec variant on a channel+barrier),
    and slip, each against the torch backend on the card."""
    cfg = LatticeConfig(nx=48, ny=96, dtype="bfloat16")
    walls = _plate_48x96()
    before = fk.VARIANT_LAUNCHES["bf16-spec"]
    out = Simulation(cfg, walls, backend="cuda").run(20).state()
    assert fk.VARIANT_LAUNCHES["bf16-spec"] == before + 20
    ref = Simulation(cfg, walls, backend="torch", device=cuda_device).run(20).state()
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0.05, atol=2e-3)
    cfg = LatticeConfig(nx=48, ny=96, dtype=np.float32)
    walls, slip_x, slip_y = _slip_scene(48, 96)
    runs = [Simulation(cfg, walls, backend=b, device=cuda_device, slip_x=slip_x,
                       slip_y=slip_y).run(20).state() for b in ("cuda", "torch")]
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-4, atol=1e-7)


def _perturbed_pair(cfg, device):
    rng = np.random.default_rng(0)
    f0 = initial_state(cfg) * (1 + 0.05 * rng.uniform(-1, 1, (9, cfg.nx, cfg.ny)))
    return df64.from_f64(f0, device)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name", ["barrier", "column0", "empty"])
def test_ds_kernel_equals_step_reference(name, exact, cuda_device):
    cfg, walls = _scene(name, np.float64)
    a = _perturbed_pair(cfg, cuda_device)
    b = df64.DS(torch.empty_like(a.hi), torch.empty_like(a.lo))
    solid = torch.as_tensor(walls.astype(np.uint8), device=cuda_device)
    has_walls = bool(walls.any())
    before = fdk.LAUNCHES
    for _ in range(10):
        fdk.step(a, b, solid, cfg, has_walls=has_walls, exact=exact)
        ref = fdk.step_reference(a.hi, a.lo, solid if has_walls else None, cfg, exact)
        torch.cuda.synchronize()
        assert torch.equal(b.hi, ref.hi) and torch.equal(b.lo, ref.lo)
        a, b = b, a
    assert fdk.LAUNCHES == before + 10


@pytest.mark.cuda
def test_ds_wrapper_refuses_aliased_buffers(cuda_device):
    cfg, walls = _scene("barrier", np.float64)
    a = _perturbed_pair(cfg, cuda_device)
    solid = torch.as_tensor(walls.astype(np.uint8), device=cuda_device)
    shared = torch.empty_like(a.hi)
    cases = (
        a,                                         # dst is src
        df64.DS(torch.empty_like(a.hi), a.lo),     # one component shared
        df64.DS(shared, shared),                   # dst.hi is dst.lo
        df64.DS(a.hi.view_as(a.hi), torch.empty_like(a.lo)),  # a view of src.hi
    )
    before = fdk.LAUNCHES
    for dst in cases:
        with pytest.raises(ValueError, match="four distinct buffers"):
            fdk.step(a, dst, solid, cfg, has_walls=True)
    assert fdk.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_ds64_backend_counts_launches_and_tracks_torch(cuda_device):
    cfg, walls = _scene("column0", np.float64)
    before = fdk.LAUNCHES
    out = Simulation(cfg, walls, backend="cuda-ds64").run(20).state()
    assert fdk.LAUNCHES == before + 20
    ref = Simulation(cfg, walls, backend="torch").run(20).state()
    assert out.dtype == np.float64
    err = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-30)
    assert err.max() < 1e-11
    with pytest.raises(ValueError, match="float64"):
        Simulation(LatticeConfig(nx=24, ny=40, dtype=np.float32), walls, backend="cuda-ds64")
