"""The anatomy path of the port on the CPU: the flat multi-step kernel's
plain version against the JAX flat Pallas kernel (interpret mode) and the
golden oracle, the four probes' plain versions against the JAX probe
bodies, and the script's refusals. tests/test_torch_cuda.py holds the
five kernels themselves against these plain versions on a CUDA card.

Tolerances. Flat, float32: rtol 0, atol 5e-7 after 8 steps, the JAX
package's own bar for its flat kernel against the per-pass kernel and
against golden (tests/test_pallas.py:859, :885). Flat, bf16: the JAX flat
kernel builds at temporal=1, where it rounds to bf16 after every step as
the port does: bitwise. At temporal=2, as the JAX test builds it, it
rounds every second step: the JAX bar for that pair, atol 2e-3
(tests/test_pallas.py:897-907). The probes move float32 values or add
them in one order: bitwise.

The JAX probe bodies are closures inside functions of scripts/anatomy.py
that time and print and return nothing, with no interpret switch, so each
body is restated here with jnp, line for line (jnp.roll for pltpu.roll,
which shifts the same way), and the port's plain version is held bitwise
against it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu import geometry as jgeometry
from latticeboltzmann_tpu.models import golden
from latticeboltzmann_tpu.models.engine import initial_state as jax_initial_state
from latticeboltzmann_tpu.ops import fused_kernel as jfk
from latticeboltzmann_tpu_torch import LatticeConfig, geometry
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
from latticeboltzmann_tpu_torch.ops import probes
from latticeboltzmann_tpu_torch.scripts import anatomy
from latticeboltzmann_tpu_torch.utils import interop

torch.set_num_threads(1)


# ---- the flat kernel ----

def _rough_state(cfg, seed=7):
    """tests/test_pallas.py:830-832's rough positive state, float32."""
    rng = np.random.default_rng(seed)
    f = np.asarray(initial_state(cfg), np.float64)
    return (f * (1.0 + 0.05 * rng.random(f.shape))).astype(np.float32)


def _jax_flat(jcfg, f, temporal, P):
    """P passes of `temporal` steps through the JAX flat kernel in
    interpret mode, built as tests/test_pallas.py:823-848 builds it;
    unpadded float32 result."""
    nx, ny = jcfg.nx, jcfg.ny
    nyp, lpad = jfk.pick_layout(ny, temporal)
    f_p, _ = jfk.pad_state(jnp.asarray(f.astype(jcfg.dtype)),
                           jnp.asarray(jgeometry.empty(nx, ny)), jcfg, nyp, lpad)
    flat = jfk.make_flat_step(jcfg, nx, nyp, 32, True, temporal, lpad, P, slots=4)
    out2 = flat(jnp.stack([f_p, f_p]), jnp.asarray([0], jnp.int32))
    return np.asarray(jfk.unpad_state(out2[0], jcfg, lpad).astype(jnp.float32))


def _flat_reference(cfg, f, n_steps):
    t = interop.state_tensor(f, cfg.dtype, "cpu")
    return fk.flat_reference(torch.stack([t, t]), cfg, n_steps)


def test_flat_reference_matches_the_jax_flat_kernel_and_golden():
    cfg = LatticeConfig(nx=128, ny=40, dtype=np.float32)
    jcfg = JaxConfig(nx=128, ny=40, dtype=np.float32)
    f = _rough_state(cfg)
    out = _flat_reference(cfg, f, 8)[0].numpy()
    np.testing.assert_allclose(out, _jax_flat(jcfg, f, 2, 4), rtol=0, atol=5e-7)
    # physics: from the rest state against the float64 oracle, as :873-885
    cfg64 = JaxConfig(nx=128, ny=40, dtype=np.float64)
    ref = golden.run(golden.initial_state(cfg64), jgeometry.empty(128, 40), cfg64, 8)
    rest = _flat_reference(cfg, np.asarray(jax_initial_state(jcfg)), 8)[0].numpy()
    np.testing.assert_allclose(rest, ref, rtol=0, atol=5e-7)


def test_flat_reference_bf16_equals_the_jax_flat_kernel_at_temporal_1():
    """bf16 at temporal=1: the JAX flat kernel then rounds to bf16 after
    every step, as the port does, and the two agree bitwise after 8 steps
    (8 passes of 1 step), as the port's bf16 step does with the JAX
    kernel in interpret mode (tests/test_torch_bf16.py)."""
    cfg = LatticeConfig(nx=128, ny=40, dtype="bfloat16")
    jcfg = JaxConfig(nx=128, ny=40, dtype=jnp.bfloat16)
    f = _rough_state(cfg)
    out = _flat_reference(cfg, f, 8)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out[0].float().numpy(), _jax_flat(jcfg, f, 1, 8))


def test_flat_reference_bf16_within_the_jax_bar_at_temporal_2():
    """bf16 at temporal=2, as the JAX test builds it: the JAX kernel rounds
    every second step, the port every step; the JAX package's bar for such
    a pair (tests/test_pallas.py:897-907)."""
    cfg = LatticeConfig(nx=128, ny=40, dtype="bfloat16")
    jcfg = JaxConfig(nx=128, ny=40, dtype=jnp.bfloat16)
    f = _rough_state(cfg)
    out = _flat_reference(cfg, f, 8)
    np.testing.assert_allclose(out[0].float().numpy(), _jax_flat(jcfg, f, 2, 4),
                               rtol=0, atol=2e-3)


@pytest.mark.parametrize("n_steps", [2, 4, 16])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_flat_step_on_cpu_equals_chained_run_steps(dtype, n_steps):
    """The wrapper's CPU path, in place: parity 0 holds n_steps chained
    single steps, parity 1 the state one step earlier, bitwise."""
    cfg = LatticeConfig(nx=16, ny=40, dtype=dtype, accel=0.005)
    f = _rough_state(cfg)
    f[6, 5, 0] = 1e-6  # the forcing guard fails at one column-0 site
    t = interop.state_tensor(f, cfg.dtype, "cpu")
    f2 = torch.stack([t, torch.zeros_like(t)])
    before = fk.FLAT_LAUNCHES
    out = fk.make_flat_step(cfg, n_steps)(f2)
    assert out is f2 and fk.FLAT_LAUNCHES == before  # no kernel on the CPU
    walls = geometry.empty(16, 40)
    assert torch.equal(out[0], fk.run_steps(t, walls, cfg, n_steps))
    assert torch.equal(out[1], fk.run_steps(t, walls, cfg, n_steps - 1))


def _flat_refusal(case):
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    t = torch.as_tensor(initial_state(cfg))
    f2 = torch.stack([t, t])
    if case == "walls":
        return ValueError, lambda: fk.make_flat_step(cfg, 4, walls=geometry.channel(16, 40))
    if case == "spec":
        return ValueError, lambda: fk.make_flat_step(cfg, 4, wall_spec=(("channel",),))
    if case == "slip":
        return ValueError, lambda: fk.make_flat_step(cfg, 4, slip_x=geometry.channel(16, 40))
    if case == "odd":
        return ValueError, lambda: fk.make_flat_step(cfg, 3)
    if case == "odd_call":
        return ValueError, lambda: fk.flat_step(f2, cfg, 5)
    if case == "unstacked":
        return ValueError, lambda: fk.flat_step(t, cfg, 4)
    if case == "strided":
        return ValueError, lambda: fk.flat_step(torch.stack([t, t], dim=1).transpose(0, 1), cfg, 4)
    if case == "dtype":
        return TypeError, lambda: fk.flat_step(f2.to(torch.bfloat16), cfg, 4)
    if case == "f64_config":
        return NotImplementedError, lambda: fk.make_flat_step(
            LatticeConfig(nx=16, ny=40, dtype=np.float64), 4)
    if case == "no_card":
        return RuntimeError, lambda: fk.flat_step(f2.to("meta"), cfg, 4)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["walls", "spec", "slip", "odd", "odd_call", "unstacked",
                                  "strided", "dtype", "f64_config", "no_card"])
def test_flat_guards(case):
    """Walls, a wall spec, slip masks and an odd count raise ValueError as
    the JAX guards do (ops/fused_kernel.py:387-404, tests/test_pallas.py:
    888-894); so does anything that is not the stacked pair."""
    exc, call = _flat_refusal(case)
    before = fk.FLAT_LAUNCHES
    with pytest.raises(exc):
        call()
    assert fk.FLAT_LAUNCHES == before


def test_flat_step_takes_an_all_fluid_mask():
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    t = torch.as_tensor(initial_state(cfg))
    out = fk.make_flat_step(cfg, 2, walls=geometry.empty(16, 40), wall_spec=())(torch.stack([t, t]))
    assert torch.equal(out[0], fk.run_steps(t, geometry.empty(16, 40), cfg, 2))


# ---- the probes ----

BLOCK_SHAPES = [(32, 128), (40, 128), (32, 40), (40, 37)]


def _block(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(np.float32)


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
def test_roll_y_reference_is_the_jax_probe_body(shape):
    """scripts/anatomy.py:186-190: v = x; n_rolls times v = roll(v, shift,
    axis=1). Shifts of :458: 1, NY-1, 96 and NY (the identity)."""
    x = _block(shape)
    ny, n_rolls = shape[1], 6
    for shift in (1, ny - 1, 96, ny):
        v = jnp.asarray(x)
        for _ in range(n_rolls):
            v = jnp.roll(v, shift, axis=1)
        got = probes.roll_y(torch.as_tensor(x), shift, n_rolls)
        np.testing.assert_array_equal(got.numpy(), np.asarray(v))
        # one roll by the summed shift, the kernel's stated result
        assert torch.equal(got, torch.roll(torch.as_tensor(x), n_rolls * shift % ny, 1))


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
def test_align_reference_is_the_jax_probe_body(shape):
    """scripts/anatomy.py:216-222: a = x[o:R-2+o], b = x[2-o:R-o], v = a,
    n_ops times v = v + b; along rows as written, and the same windows
    along columns (axis 1)."""
    x = _block(shape, seed=1)
    rows, n_ops = shape[0], 8
    for offset in (0, 1, 2):
        xj = jnp.asarray(x)
        a = xj[offset: rows - 2 + offset]
        b = xj[2 - offset: rows - offset]
        v = a
        for _ in range(n_ops):
            v = v + b
        got = probes.align(torch.as_tensor(x), offset, n_ops, axis=0)
        assert got.shape == (rows - 2, shape[1])
        np.testing.assert_array_equal(got.numpy(), np.asarray(v))
        # axis 1 is axis 0 of the transposed block
        xt = jnp.asarray(x.T)
        vt = xt[offset: shape[1] - 2 + offset]
        for _ in range(n_ops):
            vt = vt + xt[2 - offset: shape[1] - offset]
        got = probes.align(torch.as_tensor(x), offset, n_ops, axis=1)
        assert got.shape == (rows, shape[1] - 2) and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(vt).T)


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
def test_roll_x_reference_is_the_jax_probe_body(shape):
    """scripts/anatomy.py:246-250: n_rolls times v = roll(v, shift,
    axis=0); shifts 1 and R-1 (:463, 39 on 40 rows)."""
    x = _block(shape, seed=2)
    rows, n_rolls = shape[0], 8
    for shift in (1, rows - 1):
        v = jnp.asarray(x)
        for _ in range(n_rolls):
            v = jnp.roll(v, shift, axis=0)
        for mechanism in ("shared", "global"):
            got = probes.roll_x(torch.as_tensor(x), shift, n_rolls, mechanism=mechanism)
            np.testing.assert_array_equal(got.numpy(), np.asarray(v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(9, 24, 40), (9, 24, 37)])
def test_copy_state_on_cpu_and_its_refusals(shape, dtype):
    """dst = src on the CPU path (no launch counted), direct and staged;
    the staged form refuses a tile that is no multiple of 16 bytes (an odd
    NY with the wrong row count), a row count that does not divide NX, too
    many or too large stages, and a persistent grid (a direct-form design)."""
    src = torch.as_tensor(_block(shape, seed=3)).to(dtype)
    before = dict(probes.LAUNCHES)
    for kw in ({}, {"ctas_per_sm": 8}, {"rows": 8, "stages": 2}, {"rows": 24, "stages": 8}):
        dst = torch.zeros_like(src)
        assert probes.copy_state(src, dst, **kw) is dst and torch.equal(dst, src)
    assert torch.equal(probes.copy_reference(src), src)
    dst = torch.zeros_like(src)
    odd_tile = shape[2] % 2 == 1
    for kw in ({"rows": 5}, {"rows": 8, "stages": 1}, {"rows": 8, "stages": 9},
               {"ctas_per_sm": 0}, {"ctas_per_sm": 8, "rows": 8},
               *([{"rows": 1}, {"rows": 3}] if odd_tile else [])):
        with pytest.raises(ValueError):
            probes.copy_state(src, dst, **kw)
    big = torch.zeros((9, 8, 16384), dtype=dtype)
    with pytest.raises(ValueError, match="shared memory"):
        probes.copy_state(big, torch.zeros_like(big), rows=8, stages=8)
    with pytest.raises(ValueError, match="distinct"):
        probes.copy_state(src, src)
    with pytest.raises(ValueError):
        probes.copy_state(src, dst.to(torch.float64))
    with pytest.raises(ValueError):
        probes.copy_state(src[:, ::2], dst[:, ::2])
    assert dict(probes.LAUNCHES) == before


def _probe_refusal(case):
    x = torch.as_tensor(_block((32, 128)))
    if case == "shuffle_far_shift":
        return ValueError, lambda: probes.roll_y(x, 96, 6, mechanism="shuffle")
    if case == "shuffle_zero_shift":
        return ValueError, lambda: probes.roll_y(x, 128, 6, mechanism="shuffle")
    if case == "mechanism":
        return ValueError, lambda: probes.roll_x(x, 1, 8, mechanism="texture")
    if case == "offset":
        return ValueError, lambda: probes.align(x, 3, 8)
    if case == "negative_count":
        return ValueError, lambda: probes.roll_y(x, 1, -1)
    if case == "float64":
        return ValueError, lambda: probes.roll_y(x.double(), 1, 6)
    if case == "strided":
        return ValueError, lambda: probes.roll_x(x.t(), 1, 8)
    if case == "out_is_x":
        return ValueError, lambda: probes.roll_y(x, 1, 6, out=x)
    if case == "no_card":
        return RuntimeError, lambda: probes.align(x.to("meta"), 1, 8)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["shuffle_far_shift", "shuffle_zero_shift", "mechanism",
                                  "offset", "negative_count", "float64", "strided",
                                  "out_is_x", "no_card"])
def test_probe_wrappers_refuse(case):
    exc, call = _probe_refusal(case)
    before = dict(probes.LAUNCHES)
    with pytest.raises(exc):
        call()
    assert dict(probes.LAUNCHES) == before


def test_shuffle_mechanism_on_cpu_takes_near_shifts():
    """Shifts within 31 columns of 0 either way pass the shuffle
    mechanism's check (the plain version runs on the CPU)."""
    x = torch.as_tensor(_block((32, 40)))
    for shift in (1, 39, 31, -31, 9):
        assert torch.equal(probes.roll_y(x, shift, 3, mechanism="shuffle"),
                           torch.roll(x, 3 * shift % 40, 1))


# ---- the script ----

def test_anatomy_sections_are_the_ported_set():
    assert set(anatomy.SECTIONS) == {"all", "copy", "roll", "align", "flat", "prod", "bf16"}
    assert set(anatomy.TPU_LABS) == {"xla", "ablate", "sweep", "floor", "skew", "launchtax",
                                     "slim", "split"}
    args = anatomy.build_parser().parse_args([])
    assert (args.section, args.steps, args.nx, args.ny) == ("all", 400, 800, 4000)
    for name in anatomy.SECTIONS:
        assert anatomy.build_parser().parse_args(["--section", name]).section == name


@pytest.mark.parametrize("name", ["ablate", "sweep", "floor", "skew", "launchtax", "slim",
                                  "split", "xla", "nonsense"])
def test_anatomy_refuses_tpu_labs_and_unknown_sections(name, capsys):
    with pytest.raises(SystemExit) as e:
        anatomy.main(["--section", name])
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert name in err and ("not ported" in err if name in anatomy.TPU_LABS else "unknown" in err)


def test_anatomy_without_a_card_exits_nonzero_and_runs_nothing(monkeypatch, capsys):
    """No CPU mode: without a card every section returns non-zero with a
    message before any section runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    for name in ("copy_section", "roll_section", "align_section", "flat_section",
                 "prod_section", "bf16_section"):
        monkeypatch.setattr(anatomy, name, lambda *a, _n=name: ran.append(_n))
    for section in ("copy", "all"):
        assert anatomy.main(["--section", section]) != 0
    assert not ran
    assert "no CUDA card" in capsys.readouterr().err
