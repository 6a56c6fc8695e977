"""The wide form of the single-chip stream-collide kernel
(csrc/lbm_wide_step.cu), as far as the CPU reaches it: its plain version
step_reference_wide, which assembles the pull the way the kernel does
(aligned V-column vectors, the neighbour's element, the wrap loads, the
forcing guard in the two owners that pull from column 0), the host's
choice of form, and the wrapper's refusals. tests/test_torch_cuda.py
holds the kernel itself, on a card.

Tolerances: step_reference_wide moves and adds the same float32 values
in the same order as step_reference, so the bar between the two is
bitwise equality, for float32 and bf16 storage. Against the JAX fused
kernel in interpret mode the bar is that of
tests/test_torch_kernel.py::test_step_reference_matches_pallas_interpret_and_golden,
5e-7 after 3 steps (the JAX kernel's own bar against golden).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu.ops import fused_kernel as jfk
from latticeboltzmann_tpu_torch import LatticeConfig, geometry
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
from latticeboltzmann_tpu_torch.utils.interop import state_tensor

torch.set_num_threads(1)

DTYPES = [np.float32, "bfloat16"]


def _scene(name, v, dtype):
    """(cfg, walls): the comparison scenes of tests/test_torch_kernel.py,
    and two whose rows are one and two threads wide (NY == V, NY == 2V)."""
    if name == "barrier_16x40":
        walls = geometry.channel(16, 40)
        walls[5:9, 10:13] = True
        return LatticeConfig(nx=16, ny=40, dtype=dtype), walls
    if name == "column0_24x40":
        walls = geometry.channel(24, 40)
        walls[8:14, 0:3] = True
        return LatticeConfig(nx=24, ny=40, dtype=dtype, accel=0.005), walls
    ny = v if name == "ny_is_v" else 2 * v
    return LatticeConfig(nx=8, ny=ny, dtype=dtype, accel=0.005), geometry.channel(8, ny)


def _geometry(kind, walls):
    """(class plane or None, wall spec or None) of one geometry source."""
    if kind == "wall-free":
        return None, None
    if kind == "plane":
        return torch.as_tensor(walls.astype(np.uint8)), None
    if kind == "spec":
        spec = geometry.infer_spec(walls)
        assert spec is not None
        return None, spec
    # slip codes: the top wall row becomes slip_x, and a slip_y block
    walls = walls.copy()
    slip_x, slip_y = np.zeros_like(walls), np.zeros_like(walls)
    slip_x[0], walls[0] = True, False
    slip_y[2:4, 1:3] = True
    cls = fk.class_plane(walls, slip_x, slip_y)
    assert set(np.unique(cls)) == {0, 1, 2, 3}
    return torch.as_tensor(cls), None


def _perturbed(cfg, seed=0):
    """Rest equilibrium times 5% noise, with the forcing guard failing at
    one column-0 site; in the config's storage dtype."""
    rng = np.random.default_rng(seed)
    f0 = initial_state(cfg) * (1 + 0.05 * rng.uniform(-1, 1, (9, cfg.nx, cfg.ny)))
    f0[6, cfg.nx // 2, 0] = 1e-6
    return state_tensor(f0.astype(np.float32), cfg.dtype, "cpu")


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("v", [2, 4, 8])
@pytest.mark.parametrize("kind", ["wall-free", "plane", "slip", "spec"])
@pytest.mark.parametrize("name", ["barrier_16x40", "column0_24x40", "ny_is_v", "ny_is_2v"])
def test_step_reference_wide_equals_step_reference(name, kind, v, dtype):
    cfg, walls = _scene(name, v, dtype)
    plane, spec = _geometry(kind, walls)
    f = _perturbed(cfg)
    for _ in range(3):
        want = fk.step_reference(f, plane, cfg, wall_spec=spec)
        got = fk.step_reference_wide(f, plane, cfg, v, wall_spec=spec)
        assert got.dtype == f.dtype and got.shape == f.shape
        assert torch.equal(_bits(got), _bits(want))
        f = want


def test_step_reference_wide_matches_pallas_interpret():
    cfg, walls = _scene("column0_24x40", 4, np.float32)
    solid = torch.as_tensor(walls.astype(np.uint8))
    f = torch.as_tensor(initial_state(cfg))
    for _ in range(3):
        f = fk.step_reference_wide(f, solid, cfg, 4)
    jcfg = JaxConfig(nx=cfg.nx, ny=cfg.ny, accel=cfg.accel, dtype=np.float32)
    pallas = np.asarray(jfk.run_steps(
        jnp.asarray(initial_state(cfg)), jnp.asarray(walls), jcfg, 3, interpret=True
    ))
    np.testing.assert_allclose(f.numpy(), pallas, rtol=0, atol=5e-7)


@pytest.mark.parametrize("v, ny", [(4, 37), (3, 40), (1, 40), (0, 40), (4.0, 40)])
def test_step_reference_wide_refuses_what_the_form_does_not_take(v, ny):
    cfg = LatticeConfig(nx=8, ny=ny, dtype=np.float32)
    with pytest.raises(ValueError, match="multiple of v"):
        fk.step_reference_wide(torch.as_tensor(initial_state(cfg)), None, cfg, v)


def _offset_view(shape, dtype, elements):
    """A contiguous tensor of `shape` that starts `elements` elements into
    a larger buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + elements, dtype=dtype)[elements:].view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_form_follows_shape_and_pointers(dtype):
    aligned = [0, 4096, 1 << 33]
    assert fk.kernel_form(dtype, 40, aligned) == "wide"
    assert fk.kernel_form(dtype, 4000, aligned) == "wide"
    assert fk.kernel_form(dtype, 16000, aligned) == "wide"
    assert fk.kernel_form(dtype, 37, aligned) == "narrow"
    assert fk.kernel_form(dtype, fk.WIDE_COLUMNS[dtype], aligned[:2]) == "wide"
    # NY a multiple of the float32 count only
    assert fk.kernel_form(dtype, 12, aligned) == ("wide" if dtype == torch.float32 else "narrow")
    # a contiguous view at an odd element offset: contiguity is not alignment
    a = torch.zeros((9, 16, 40), dtype=dtype)
    view = _offset_view((9, 16, 40), dtype, 1)
    assert view.is_contiguous() and view.data_ptr() % fk.WIDE_ALIGN != 0
    assert fk.kernel_form(dtype, 40, [a.data_ptr(), a.data_ptr()]) == "wide"
    assert fk.kernel_form(dtype, 40, [view.data_ptr(), a.data_ptr()]) == "narrow"
    assert fk.kernel_form(dtype, 40, [a.data_ptr(), view.data_ptr()]) == "narrow"
    assert fk.kernel_form(dtype, 40, [a.data_ptr(), a.data_ptr(), 24]) == "narrow"  # the plane
    assert fk.kernel_form(torch.float64, 40, aligned) == "narrow"


def test_a_wide_thread_owns_one_16_byte_vector():
    assert fk.WIDE_ALIGN == 16
    assert all(fk.WIDE_ALIGN == v * torch.empty((), dtype=d).element_size()
               for d, v in fk.WIDE_COLUMNS.items())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["wall-free", "plane", "spec"])
def test_step_takes_a_form_on_the_cpu(kind, dtype):
    """On a CPU tensor form="wide" runs the wide form's plain version and
    form="narrow" or None step_reference; all agree bit for bit, and none
    counts a launch."""
    cfg, walls = _scene("column0_24x40", 0, dtype)
    plane, spec = _geometry(kind, walls)
    geom = spec if spec is not None else plane
    src = _perturbed(cfg)
    before = (fk.LAUNCHES, dict(fk.FORM_LAUNCHES))
    outs = [fk.step(src, torch.empty_like(src), geom, cfg, form=form)
            for form in (None, "narrow", "wide")]
    assert torch.equal(_bits(outs[0]), _bits(outs[1]))
    assert torch.equal(_bits(outs[0]), _bits(outs[2]))
    assert (fk.LAUNCHES, dict(fk.FORM_LAUNCHES)) == before


def _wide_refusal(case):
    cfg, walls = _scene("barrier_16x40", 0, np.float32)
    src = torch.as_tensor(initial_state(cfg))
    dst = torch.empty_like(src)
    if case == "odd_ny":
        cfg37 = LatticeConfig(nx=24, ny=37, dtype=np.float32)
        s37 = torch.as_tensor(initial_state(cfg37))
        return lambda: fk.step(s37, torch.empty_like(s37), None, cfg37, form="wide")
    if case == "ny_not_a_multiple_of_8_in_bf16":
        cfg12 = LatticeConfig(nx=8, ny=12, dtype="bfloat16")
        s12 = state_tensor(initial_state(cfg12), "bfloat16", "cpu")
        return lambda: fk.step(s12, torch.empty_like(s12), None, cfg12, form="wide")
    if case == "unaligned_src":
        view = _offset_view(src.shape, src.dtype, 1).copy_(src)
        return lambda: fk.step(view, dst, None, cfg, form="wide")
    if case == "unaligned_dst":
        view = _offset_view(src.shape, src.dtype, 3)
        return lambda: fk.step(src, view, None, cfg, form="wide")
    if case == "unaligned_plane":
        plane = _offset_view(walls.shape, torch.uint8, 5).copy_(torch.as_tensor(walls))
        return lambda: fk.step(src, dst, plane, cfg, form="wide")
    if case == "unknown_form":
        return lambda: fk.step(src, dst, None, cfg, form="broad")
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["odd_ny", "ny_not_a_multiple_of_8_in_bf16", "unaligned_src",
                                  "unaligned_dst", "unaligned_plane", "unknown_form"])
def test_step_refuses_the_wide_form_where_it_cannot_run(case):
    before = (fk.LAUNCHES, dict(fk.FORM_LAUNCHES))
    with pytest.raises(ValueError, match="form"):
        _wide_refusal(case)()
    assert (fk.LAUNCHES, dict(fk.FORM_LAUNCHES)) == before


@pytest.mark.parametrize("case", ["unaligned_src", "unaligned_plane"])
def test_unaligned_views_step_without_a_form(case):
    """What the wide form refuses still steps when no form is asked for."""
    cfg, walls = _scene("barrier_16x40", 0, np.float32)
    src = torch.as_tensor(initial_state(cfg))
    plane = torch.as_tensor(walls.astype(np.uint8))
    want = fk.step_reference(src, plane, cfg)
    if case == "unaligned_src":
        src = _offset_view(src.shape, src.dtype, 1).copy_(src)
    else:
        plane = _offset_view(plane.shape, torch.uint8, 5).copy_(plane)
    assert torch.equal(fk.step(src, torch.empty_like(src), plane, cfg), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_session_on_the_cpu_is_unchanged(dtype):
    """A CPU Session still chains step_reference, whatever form a card
    would run, and counts no launch of either form."""
    cfg, walls = _scene("column0_24x40", 0, dtype)
    f = _perturbed(cfg)
    before = dict(fk.FORM_LAUNCHES)
    sess = fk.Session(cfg, walls, device="cpu", wall_spec=geometry.infer_spec(walls))
    sess.load(f)
    sess.advance(4)
    want = f
    for _ in range(4):
        want = fk.step_reference(want, torch.as_tensor(walls.astype(np.uint8)), cfg)
    assert torch.equal(_bits(sess.state()), _bits(want))
    assert dict(fk.FORM_LAUNCHES) == before
