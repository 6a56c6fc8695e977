"""The port's CUDA kernel on a CUDA card, against its plain PyTorch
version; the tests skip without a card (the kernel has no CPU mode).

This file imports neither jax nor the JAX package, so it also runs where
only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

The kernel is built with -fmad=false and IEEE division and rounds like
step_reference: the bar is bitwise equality. The facade's cuda backend
against its torch backend uses the JAX package's pallas-vs-xla bar
(rtol 1e-4, atol 1e-7 after 20 steps, tests/test_pallas.py:74-81): the
two engines associate the collision differently.
"""

import numpy as np
import pytest
import torch

from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _scene(name):
    if name == "barrier":
        walls = geometry.channel(16, 40)
        walls[5:9, 10:13] = True
        return LatticeConfig(nx=16, ny=40, dtype=np.float32), walls
    if name == "column0":
        walls = geometry.channel(24, 40)
        walls[8:14, 0:3] = True
        return LatticeConfig(nx=24, ny=40, dtype=np.float32, accel=0.005), walls
    return LatticeConfig(nx=16, ny=40, dtype=np.float32), geometry.empty(16, 40)


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
