"""The stream-collide kernel's single-chip options in the port against
the JAX package: free-slip class codes, the closed-form wall spec and
fast math, through the kernel's plain version (ops/fused_kernel.py), the
torch engine, the facade's capability sets and the CLI.

Tolerances: 5e-7 after 3 float32 steps is the JAX kernel's own bar
(tests/test_pallas.py:32-40, and tests/test_torch_kernel.py); the port
and JAX round the same ops in different association orders and with
different FMA contraction, so float32 cannot be held tighter. In bf16 the
result is rounded once per step, and the twins agree bitwise after 3
steps on both slip scenes (measured; after 10 steps two or more values
flip by one bf16 ulp, so the bar stays at 3 steps). The spec path and the
plane path compute the same mask and are held bitwise.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu import Simulation as JaxSimulation
from latticeboltzmann_tpu.ops import fused_kernel as jfk
from latticeboltzmann_tpu.ops import stream_collide as jops
from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.cli import main as cli_main
from latticeboltzmann_tpu_torch.cli import resolve_backend
from latticeboltzmann_tpu_torch.models import engine
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
from latticeboltzmann_tpu_torch.ops import stream_collide as ops
from latticeboltzmann_tpu_torch.utils import interop

torch.set_num_threads(1)

ATOL = 5e-7


def _top_row_scene(nx=24, ny=40):
    """A channel whose top wall row is slip_x, with a slip_y block
    (chip_smoke.py's slip scene): (walls, slip_x, slip_y)."""
    walls = geometry.channel(nx, ny)
    slip_x = np.zeros_like(walls)
    slip_x[0] = True
    walls[0] = False
    slip_y = np.zeros_like(walls)
    slip_y[nx // 3: nx // 3 + 2, ny // 8: ny // 8 + 2] = True
    return walls, slip_x, slip_y


def _mixed_scene(nx=32, ny=64):
    """tests/test_slip.py's mixed scene: a bounce-back block, slip_x
    channel edges and a slip_y column, all three classes in one run."""
    walls = geometry.empty(nx, ny)
    walls[nx // 3: nx // 3 + 4, ny // 4: ny // 4 + 3] = True
    slip_x = geometry.channel(nx, ny)
    slip_y = geometry.empty(nx, ny)
    slip_y[:, 2 * ny // 3] = True
    slip_y &= ~(walls | slip_x)
    return walls, slip_x, slip_y


SLIP_SCENES = {"top_row": _top_row_scene, "mixed": _mixed_scene}


def _configs(walls, dtype):
    nx, ny = walls.shape
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else dtype
    return LatticeConfig(nx=nx, ny=ny, dtype=dtype), JaxConfig(nx=nx, ny=ny, dtype=jdtype)


def _perturbed(cfg, seed=0):
    """Rest equilibrium times (1 + 5% uniform noise): (port tensor, JAX
    array) holding the same values (the same bits in bf16)."""
    rng = np.random.default_rng(seed)
    f = initial_state(cfg).astype(np.float64)
    f = (f * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, f.shape))).astype(np.float32)
    if cfg.dtype == "bfloat16":
        bits = f.astype(ml_dtypes.bfloat16).view(np.uint16)
        return interop.from_bf16_bits(bits, "cpu"), jnp.asarray(bits.view(ml_dtypes.bfloat16))
    return torch.from_numpy(f), jnp.asarray(f)


def _host(x):
    """A port tensor or a JAX array as float32 host values (exact for bf16)."""
    if torch.is_tensor(x):
        return interop.to_numpy(x)
    return np.asarray(x).astype(np.float32)


def _assert_agree(got, want, dtype):
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_host(got), _host(want))
    else:
        np.testing.assert_allclose(_host(got), _host(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("scene", sorted(SLIP_SCENES))
def test_class_plane_equals_jax(scene):
    """Codes 0-3 with precedence walls > slip_x > slip_y, also where the
    masks overlap."""
    walls, slip_x, slip_y = SLIP_SCENES[scene]()
    slip_y = slip_y | slip_x  # overlap: slip_x must win
    slip_x = slip_x | walls  # overlap: walls must win
    got = fk.class_plane(walls, slip_x, slip_y)
    want = np.asarray(jfk.class_plane(jnp.asarray(walls), slip_x, slip_y))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want.astype(np.uint8))
    np.testing.assert_array_equal(fk.class_plane(walls), walls.astype(np.uint8))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("scene", sorted(SLIP_SCENES))
def test_slip_step_reference_matches_pallas_interpret(scene, dtype):
    """The kernel's plain version with slip codes (through the CPU
    Session, which takes the class plane) against the JAX fused kernel
    in interpret mode with slip_x/slip_y, 3 steps at T=1."""
    walls, slip_x, slip_y = SLIP_SCENES[scene]()
    cfg, jcfg = _configs(walls, dtype)
    f, jf = _perturbed(cfg)
    got = fk.run_steps(f, walls, cfg, 3, slip_x=slip_x, slip_y=slip_y)
    want = jfk.run_steps(jf, jnp.asarray(walls), jcfg, 3, interpret=True,
                         slip_x=jnp.asarray(slip_x), slip_y=jnp.asarray(slip_y))
    assert got.dtype == f.dtype
    _assert_agree(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("scene", sorted(SLIP_SCENES))
def test_slip_torch_engine_matches_jax_xla(scene, dtype):
    """The port's torch engine with slip masks against the JAX xla
    engine's, 3 steps."""
    walls, slip_x, slip_y = SLIP_SCENES[scene]()
    cfg, jcfg = _configs(walls, dtype)
    f, jf = _perturbed(cfg)
    got = ops.run_steps(f, torch.as_tensor(walls), cfg, 3, torch.as_tensor(slip_x),
                        torch.as_tensor(slip_y))
    want = jops.run_steps(jf, jnp.asarray(walls), jcfg, 3, jnp.asarray(slip_x),
                          jnp.asarray(slip_y))
    _assert_agree(got, want, dtype)


@pytest.mark.parametrize("scene", sorted(SLIP_SCENES))
def test_slip_step_reference_tracks_torch_engine(scene):
    """The two plain versions of the port with slip agree in float32 (they
    differ only in association order)."""
    walls, slip_x, slip_y = SLIP_SCENES[scene]()
    cfg, _ = _configs(walls, np.float32)
    f, _ = _perturbed(cfg)
    got = fk.run_steps(f, walls, cfg, 3, slip_x=slip_x, slip_y=slip_y)
    want = ops.run_steps(f, torch.as_tensor(walls), cfg, 3, torch.as_tensor(slip_x),
                         torch.as_tensor(slip_y))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


def _spec_scenes():
    plate = geometry.channel(48, 96)
    plate[10:30, 20:25] = True
    return {
        "channel+rect": plate,
        "cylinder": geometry.channel_with_cylinder(48, 96),
        "channel": geometry.channel(48, 96),
        "reference": geometry.reference_barrier(48, 96),
    }


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("scene", sorted(_spec_scenes()))
def test_spec_path_bitwise_equals_plane_path(scene, dtype):
    """A wall spec (the mask built from the site indices) gives the
    plane path's bits, through step_reference and the CPU step wrapper."""
    walls = _spec_scenes()[scene]
    spec = geometry.infer_spec(walls)
    assert spec is not None and fk.kernel_spec(spec, *walls.shape)
    np.testing.assert_array_equal(geometry.spec_mask(spec, *walls.shape), walls)
    cfg, _ = _configs(walls, dtype)
    f, _ = _perturbed(cfg)
    plane = torch.as_tensor(walls.astype(np.uint8))
    a = fk.step_reference(f, None, cfg, wall_spec=spec)
    assert torch.equal(a, fk.step_reference(f, plane, cfg))
    b, c = torch.empty_like(f), torch.empty_like(f)
    fk.step(f, b, spec, cfg)
    fk.step(f, c, plane, cfg)
    assert torch.equal(b, a) and torch.equal(c, a)


def test_spec_matches_pallas_interpret_with_wall_spec():
    """The spec path against the JAX kernel with the same wall_spec, 3
    float32 steps."""
    walls = _spec_scenes()["cylinder"]
    spec = geometry.infer_spec(walls)
    cfg, jcfg = _configs(walls, np.float32)
    f, jf = _perturbed(cfg)
    got = fk.run_steps(f, walls, cfg, 3, wall_spec=spec)
    want = jfk.run_steps(jf, jnp.asarray(walls), jcfg, 3, interpret=True, wall_spec=spec)
    np.testing.assert_allclose(got.numpy(), _host(want), rtol=0, atol=ATOL)


def test_fast_math_step_reference_is_ieee():
    """step_reference(fast_math=True) computes IEEE 1/rho: it equals the
    fast_math=False result bitwise, and the JAX kernel in interpret mode
    with fast_math=False within the float32 bar. Not against JAX's
    fast_math=True: its interpret lowering computes the approximate
    reciprocal in bf16 (jnp.reciprocal of a bf16 cast), which is neither
    the TPU's nor the card's rcp.approx.f32. The kernel's fast-math variant
    is held to this IEEE result on the card, within a stated tolerance."""
    walls = geometry.reference_barrier(48, 96)
    spec = geometry.infer_spec(walls)
    cfg, jcfg = _configs(walls, np.float32)
    f, jf = _perturbed(cfg)
    got = fk.run_steps(f, walls, cfg, 3, wall_spec=spec, fast_math=True)
    assert torch.equal(got, fk.run_steps(f, walls, cfg, 3, wall_spec=spec))
    want = jfk.run_steps(jf, jnp.asarray(walls), jcfg, 3, interpret=True, fast_math=False)
    np.testing.assert_allclose(got.numpy(), _host(want), rtol=0, atol=ATOL)


def test_capability_sets_match_the_jax_facade():
    """The JAX facade's sets (engine.py:73-118 there), by counterpart:
    xla -> torch, pallas -> cuda, sharded(-sync) -> the same names,
    sharded-pallas(-fused, -rdma) -> sharded-cuda(-fused, -rdma)."""
    kernels = {"cuda", "sharded-cuda", "sharded-cuda-fused", "sharded-cuda-rdma"}
    assert engine._SLIP_BACKENDS == {"torch", "sharded", "sharded-sync"} | kernels
    assert engine._FASTMATH_BACKENDS == kernels
    assert engine._WALL_SPEC_BACKENDS == kernels
    assert engine._DS_BACKENDS == {"torch-ds64", "cuda-ds64", "sharded-cuda-ds64"}


@pytest.mark.parametrize("backend", ["torch-ds64", "cuda-ds64"])
def test_slip_refused_on_ds_backends(backend):
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float64)
    edges = geometry.channel(16, 40)
    with pytest.raises(NotImplementedError, match="free-slip"):
        Simulation(cfg, geometry.empty(16, 40), backend=backend, slip_x=edges)


def test_facade_slip_matches_jax_facade():
    """Simulation(slip_x=, slip_y=) on the torch backend against the JAX
    facade on xla, float32, 5 steps; the torch backend takes no wall spec."""
    walls, slip_x, slip_y = _mixed_scene()
    cfg, jcfg = _configs(walls, np.float32)
    sim = Simulation(cfg, walls, backend="torch", slip_x=slip_x, slip_y=slip_y).run(5)
    jsim = JaxSimulation(jcfg, walls, backend="xla", slip_x=slip_x, slip_y=slip_y).run(5)
    assert sim.wall_spec is None
    np.testing.assert_allclose(sim.state(), np.asarray(jsim.state()), rtol=0, atol=ATOL)
    plain = Simulation(cfg, walls, backend="torch").run(5)
    assert np.abs(sim.state() - plain.state()).max() > 1e-6


def test_fast_math_ignored_off_its_backends():
    """fast_math on the torch backend is kept on the facade and ignored
    by the run, as in the JAX facade."""
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    walls = geometry.channel_with_barrier(16, 40)
    fast = Simulation(cfg, walls, backend="torch", fast_math=True).run(5)
    ieee = Simulation(cfg, walls, backend="torch").run(5)
    assert fast.fast_math and not ieee.fast_math
    np.testing.assert_array_equal(fast.state(), ieee.state())


def _cli_re(capsys, *extra):
    argv = ["--nx", "16", "--ny", "40", "--steps", "10", "--backend", "torch",
            "--print-stats-every", "5", "--warmup", "1", *extra]
    assert cli_main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    return lines[0], float(lines[-2].split(" Re ")[1])


def test_cli_fast_math_flag(capsys):
    """--fast-math parses and, on the torch backend, changes nothing."""
    banner, re_fast = _cli_re(capsys, "--fast-math")
    assert "backend=torch precision=f32" in banner
    assert re_fast == _cli_re(capsys)[1]


@pytest.mark.parametrize("card", [True, False])
def test_auto_backend_takes_bf16(card, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    assert resolve_backend("auto", "bfloat16") == ("cuda" if card else "torch")
    assert resolve_backend("cuda", "bfloat16") == "cuda"


@pytest.mark.parametrize("extra", [["--precision", "bf16"], ["--fast-math"]])
def test_cli_cuda_without_a_card_raises(extra, monkeypatch):
    """No fallback: an explicit cuda backend with no card raises, in bf16
    and with fast math alike."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        cli_main(["--nx", "16", "--ny", "40", "--steps", "2", "--backend", "cuda", *extra])
