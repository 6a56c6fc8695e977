"""The port's CUDA kernels on a CUDA card, against their plain PyTorch
versions; the tests skip without a card (a kernel has no CPU mode).

This file imports neither jax nor the JAX package, so it also runs where
only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

The kernels are built with -fmad=false and IEEE division (the ds kernel
writes every op as an _rn intrinsic) and round like their step_reference:
the bar is bitwise equality. The facade's cuda backend
against its torch backend uses the JAX package's pallas-vs-xla bar
(rtol 1e-4, atol 1e-7 after 20 steps, tests/test_pallas.py:74-81): the
two engines associate the collision differently. The cuda-ds64 backend
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["barrier", "column0", "empty"])
def test_kernel_equals_step_reference(name, cuda_device):
    cfg, walls = _scene(name)
    rng = np.random.default_rng(0)
    f0 = initial_state(cfg) * (1 + 0.05 * rng.uniform(-1, 1, (9, cfg.nx, cfg.ny)))
    a = torch.as_tensor(f0.astype(np.float32), device=cuda_device)
    b = torch.empty_like(a)
    solid = torch.as_tensor(walls.astype(np.uint8), device=cuda_device)
    has_walls = bool(walls.any())
    before = fk.LAUNCHES
    for _ in range(10):
        fk.step(a, b, solid, cfg, has_walls=has_walls)
        ref = fk.step_reference(a, solid if has_walls else None, cfg)
        torch.cuda.synchronize()
        assert torch.equal(b, ref)
        a, b = b, a
    assert fk.LAUNCHES == before + 10


@pytest.mark.cuda
def test_cuda_backend_tracks_torch_backend(cuda_device):
    cfg, walls = _scene("column0")
    before = fk.LAUNCHES
    out = Simulation(cfg, walls, backend="cuda").run(20).state()
    assert fk.LAUNCHES == before + 20
    ref = Simulation(cfg, walls, backend="torch", device=cuda_device).run(20).state()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-7)
    with pytest.raises(NotImplementedError, match="ROADMAP B3"):
        Simulation(LatticeConfig(nx=16, ny=40, dtype=np.float64), walls[:16],
                   backend="cuda")


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
