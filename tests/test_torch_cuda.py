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
1e-11 relative (tests/test_ds.py:213-229). The ext-halo forms of both
kernels (the row-sharded path) are held bitwise against their plain
versions (step_reference_ext) on meshes of virtual shards of the card,
and the sharded-cuda backend bitwise against the cuda backend. The rdma
form (the halo exchange inside the kernel, one launch per shard on a
stream of its own) is held bitwise against step_reference_rdma, comm rows
and flags included, and sharded-cuda-rdma against cuda; a withheld send
must end in a raised timeout. The ds kernel's temporal form (a pass of L
pair steps per launch) is held bitwise against the chain of step_reference
and its tiled plain version at every L both of its tiles take, and the
cuda-ds64 path's launches are counted per form; its ext-halo form (a
shard's pass, the rows beyond it from Td-row halos) bitwise against
temporal_reference_ext and its tiled plain version over whole shards,
edge bands and interiors, and the sharded-cuda-ds64 path's launches
counted per form. The four
anatomy probes (ops/probes.py) and the flat multi-step kernel are held
bitwise against their plain versions: they move float32 values, add them
in one order, or repeat the step kernel's arithmetic. The single-chip
kernel's two forms (wide: several columns per thread, 16-byte accesses;
narrow: one site per thread) are each held bitwise against step_reference
and against each other; so are the two forms of the ext-halo and rdma
kernels, against step_reference_ext / step_reference_rdma, the wide plain
version step_reference_ext_wide and each other. Both forms of the
shared-memory rolls (wide: 16-byte vectors, the y-roll's rows across a
thread-block cluster of 4 CTAs; narrow: a row or a 128-column tile per
CTA) are held bitwise against
their plain versions and one torch.roll, their launches counted by form.
"""

import collections
import ctypes
import itertools

import numpy as np
import pytest
import torch

from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import df64
from latticeboltzmann_tpu_torch.ops import fused_ds_kernel as fdk
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
from latticeboltzmann_tpu_torch.ops import probes
from latticeboltzmann_tpu_torch.parallel import sharded
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


def _offset_view(t, elements):
    """A contiguous copy of t that starts `elements` elements into a
    larger buffer: contiguous, and not aligned to 16 bytes."""
    buf = torch.zeros(t.numel() + elements, dtype=t.dtype, device=t.device)
    return buf[elements:].view(t.shape).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 40), (24, 40), (8, 0), (8, -2), (24, 37), (48, 96)])
def test_wide_form_equals_step_reference_and_narrow_form(shape, dtype, cuda_device):
    """Both forms of the single-chip kernel against step_reference and
    each other, bitwise, for every geometry source: at the comparison
    scenes, at NY == V and NY == 2V (given as 0 and -2), and at 24x37,
    which the wide form must refuse. The library's column counts are the
    host's."""
    st = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    v = fk.WIDE_COLUMNS[st]
    lib = fk.cuda_build.load_library()
    assert lib.lbm_wide_columns(fk._STORAGE[st]) == v
    nx, ny = shape[0], (v if shape[1] == 0 else 2 * v if shape[1] == -2 else shape[1])
    cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype, accel=0.005)
    walls = geometry.channel(nx, ny)
    walls[nx // 3: nx // 2, 0:3] = True
    slip_walls, slip_x, slip_y = _slip_scene(nx, ny)
    spec = geometry.infer_spec(walls)
    assert spec is not None
    geoms = [None, torch.as_tensor(walls.astype(np.uint8), device=cuda_device), spec,
             torch.as_tensor(fk.class_plane(slip_walls, slip_x, slip_y), device=cuda_device)]
    for geom in geoms:
        a = _perturbed(cfg, cuda_device)
        a[6, nx // 2, 0] = 1e-6  # the forcing guard fails at one column-0 site
        for _ in range(5):
            ref = _reference(a, geom, cfg)
            narrow = fk.step(a, torch.empty_like(a), geom, cfg, form="narrow")
            torch.cuda.synchronize()
            assert torch.equal(narrow, ref)
            if ny % v:
                before = fk.LAUNCHES
                with pytest.raises(ValueError, match="wide form"):
                    fk.step(a, torch.empty_like(a), geom, cfg, form="wide")
                assert fk.LAUNCHES == before
            else:
                before = fk.FORM_LAUNCHES["wide"]
                wide = fk.step(a, torch.full_like(a, float("nan")), geom, cfg, form="wide")
                torch.cuda.synchronize()
                assert fk.FORM_LAUNCHES["wide"] == before + 1
                assert torch.equal(wide, ref) and torch.equal(wide, narrow)
            a = ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_form_follows_the_pointers_on_the_card(dtype, cuda_device):
    """A state that is a contiguous view at an odd element offset takes the
    narrow form, an aligned one the wide form, with one result; asking for
    the wide form on the view raises and launches nothing."""
    cfg, walls = _scene("column0", dtype)
    plane = torch.as_tensor(walls.astype(np.uint8), device=cuda_device)
    a = _perturbed(cfg, cuda_device)
    ref = fk.step_reference(a, plane, cfg)
    for src, dst, solid, form in (
            (a, torch.empty_like(a), plane, "wide"),
            (_offset_view(a, 1), torch.empty_like(a), plane, "narrow"),
            (a, _offset_view(a, 3), plane, "narrow"),
            (a, torch.empty_like(a), _offset_view(plane, 5), "narrow")):
        before = dict(fk.FORM_LAUNCHES)
        out = fk.step(src, dst, solid, cfg)
        torch.cuda.synchronize()
        assert fk.FORM_LAUNCHES[form] == before.get(form, 0) + 1
        assert torch.equal(out, ref)
        if form == "narrow":
            before = fk.LAUNCHES
            with pytest.raises(ValueError, match="wide form"):
                fk.step(src, dst, solid, cfg, form="wide")
            assert fk.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_backend_runs_the_form_kernel_form_names(cuda_device):
    """Session's buffers are aligned: at temporal=1 (the one-step kernel)
    24x40 runs the wide form, 24x37 the narrow one, each counted by
    form."""
    for ny, form in ((40, "wide"), (37, "narrow")):
        cfg = LatticeConfig(nx=24, ny=ny, dtype=np.float32)
        assert fk.kernel_form(torch.float32, ny, ()) == form
        before = fk.FORM_LAUNCHES[form]
        Simulation(cfg, geometry.channel(24, ny), backend="cuda", temporal=1).run(7)
        assert fk.FORM_LAUNCHES[form] == before + 7


@pytest.mark.cuda
def test_fast_math_within_its_tolerance(cuda_device):
    cfg = LatticeConfig(nx=48, ny=96, dtype=np.float32)
    spec = geometry.infer_spec(_plate_48x96())
    for form in fk.FORMS:
        a = _perturbed(cfg, cuda_device)
        ref, b = a.clone(), torch.empty_like(a)
        for _ in range(fk.FAST_MATH_STEPS):
            fk.step(a, b, spec, cfg, fast_math=True, form=form)
            a, b = b, a
            ref = fk.step_reference(ref, None, cfg, wall_spec=spec, fast_math=True)
        assert float(((a - ref).abs() / ref.abs()).max()) <= fk.FAST_MATH_RTOL


@pytest.mark.cuda
def test_cuda_backend_tracks_torch_backend(cuda_device):
    cfg, walls = _scene("column0")  # channel + rect: the spec variant
    before = fk.VARIANT_LAUNCHES["f32-spec"]
    out = Simulation(cfg, walls, backend="cuda", temporal=1).run(20).state()
    assert fk.VARIANT_LAUNCHES["f32-spec"] == before + 20
    ref = Simulation(cfg, walls, backend="torch", device=cuda_device).run(20).state()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-7)
    # float64 has no kernel: the facade runs the torch engine on the card,
    # reported as such; the kernel session itself still refuses it
    cfg64 = LatticeConfig(nx=16, ny=40, dtype=np.float64)
    sim64 = Simulation(cfg64, walls[:16], backend="cuda")
    assert sim64.form == fk.F64_FORM and sim64._session is None
    assert sim64.device.type == "cuda"
    with pytest.raises(NotImplementedError, match="ROADMAP B15"):
        fk.Session(cfg64, walls[:16], device=cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("slip", [False, True])
def test_cuda_float64_runs_the_torch_engine_on_the_card(slip, cuda_device):
    """backend="cuda" with a float64 config on the card: the torch
    engine with no kernel session, reported as fused_kernel.F64_FORM and
    counted in F64_STEPS, no kernel launched; bitwise equal to
    backend="torch" on the card in run(), run_probed() and reynolds(),
    with the slip masks reaching the engine."""
    cfg = LatticeConfig(nx=48, ny=96, dtype=np.float64)
    walls = _plate_48x96()
    kw = {}
    if slip:
        walls, slip_x, slip_y = _slip_scene(48, 96)
        kw = {"slip_x": slip_x, "slip_y": slip_y}
    steps, launches = fk.F64_STEPS, fk.LAUNCHES
    sim = Simulation(cfg, walls, backend="cuda", temporal=6, **kw)
    ref = Simulation(cfg, walls, backend="torch", device=cuda_device, **kw)
    assert sim.form == fk.F64_FORM and sim._session is None and sim.device.type == "cuda"
    sim.run(20)
    ref.run(20)
    assert fk.F64_STEPS == steps + 20 and fk.LAUNCHES == launches
    np.testing.assert_array_equal(sim.state(), ref.state())
    assert sim.reynolds() == ref.reynolds()
    probes_ = [(10, 40), (30, 90)]
    np.testing.assert_array_equal(sim.run_probed(12, probes_, every=4),
                                  ref.run_probed(12, probes_, every=4))
    np.testing.assert_array_equal(sim.state(), ref.state())


@pytest.mark.cuda
def test_cuda_bf16_and_slip_track_torch_backend(cuda_device):
    """bf16 through the facade (the spec variant on a channel+barrier),
    and slip, each against the torch backend on the card."""
    cfg = LatticeConfig(nx=48, ny=96, dtype="bfloat16")
    walls = _plate_48x96()
    before = fk.VARIANT_LAUNCHES["bf16-spec"]
    out = Simulation(cfg, walls, backend="cuda", temporal=1).run(20).state()
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
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("name", ["symmetric channel", "plate", "empty"])
def test_ds_kernel_chain_from_rest_equals_step_reference(name, exact, cuda_device):
    """300 fast or 150 exact steps from rest at 48x96, the kernel's chain
    against step_reference's, bitwise at the end: the kernel forms a
    product's error by one FMA where the plain version splits, and the
    near-zero velocities of a flow starting from rest (on a symmetric
    channel the cross-channel one stays near zero) are where its products
    come closest to the edge of the domain in which the two agree."""
    walls = {"symmetric channel": geometry.channel(48, 96), "plate": _plate_48x96(),
             "empty": geometry.empty(48, 96)}[name]
    cfg = LatticeConfig(nx=48, ny=96, dtype=np.float64)
    solid = torch.as_tensor(walls.astype(np.uint8), device=cuda_device)
    has_walls = bool(walls.any())
    ref = df64.from_f64(initial_state(cfg), cuda_device)
    a = df64.DS(ref.hi.clone(), ref.lo.clone())
    b = df64.DS(torch.empty_like(a.hi), torch.empty_like(a.lo))
    steps = 150 if exact else 300
    before = fdk.LAUNCHES
    for _ in range(steps):
        fdk.step(a, b, solid, cfg, has_walls=has_walls, exact=exact)
        a, b = b, a
        ref = fdk.step_reference(ref.hi, ref.lo, solid if has_walls else None, cfg, exact)
    torch.cuda.synchronize()
    assert fdk.LAUNCHES == before + steps
    assert torch.equal(a.hi, ref.hi) and torch.equal(a.lo, ref.lo)


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
    """20 steps of cuda-ds64 at 24x40: 5 counted passes of DS_TEMPORAL = 4
    steps of the temporal form and no one-step launch; within the pair-DP
    bar of the float64 torch backend."""
    cfg, walls = _scene("column0", np.float64)
    before = (fdk.LAUNCHES, fdk.TEMPORAL_LAUNCHES, fdk.TEMPORAL_STEPS)
    out = Simulation(cfg, walls, backend="cuda-ds64").run(20).state()
    assert (fdk.LAUNCHES, fdk.TEMPORAL_LAUNCHES, fdk.TEMPORAL_STEPS) == (
        before[0], before[1] + 5, before[2] + 20)
    ref = Simulation(cfg, walls, backend="torch").run(20).state()
    assert out.dtype == np.float64
    err = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-30)
    assert err.max() < 1e-11
    with pytest.raises(ValueError, match="float64"):
        Simulation(LatticeConfig(nx=24, ny=40, dtype=np.float32), walls, backend="cuda-ds64")


def _ds_temporal_scene(nx, ny, device):
    """A perturbed pair on the card with the forcing guard failing at one
    column-0 site, and a channel whose walls reach column 0: (cfg, pair,
    solid plane)."""
    cfg = LatticeConfig(nx=nx, ny=ny, dtype=np.float64, accel=0.005)
    rng = np.random.default_rng(1)
    f0 = initial_state(cfg) * (1 + 0.05 * rng.uniform(-1, 1, (9, nx, ny)))
    f0[6, nx // 2, 0] = 1e-6
    walls = geometry.channel(nx, ny)
    walls[nx // 3: nx // 3 + 2, 0:3] = True
    return cfg, df64.from_f64(f0, device), torch.as_tensor(walls.astype(np.uint8), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("has_walls", [True, False])
def test_ds_temporal_kernel_equals_its_plain_versions(has_walls, exact, cuda_device):
    """One pass of the ds temporal form at every L its tile takes, at
    37x64 and 13x36 (ragged tiles), bitwise against temporal_reference
    (the chain of step_reference) and, at L 1-2, against
    temporal_reference_blocked at the card's tile; every pass a counted
    launch."""
    for nx, ny in ((37, 64), (13, 36)):
        cfg, a, solid = _ds_temporal_scene(nx, ny, cuda_device)
        solid = solid if has_walls else None
        info = fdk.temporal_info(exact, has_walls)
        before = (fdk.TEMPORAL_LAUNCHES, fdk.TEMPORAL_STEPS, fdk.LAUNCHES)
        ref = a
        for steps in range(1, info["max_steps"] + 1):
            ref = fdk.step_reference(ref.hi, ref.lo, solid, cfg, exact)
            b = df64.DS(torch.full_like(a.hi, float("nan")), torch.full_like(a.lo, float("nan")))
            fdk.temporal_step(a, b, solid, cfg, steps, has_walls=has_walls, exact=exact)
            torch.cuda.synchronize()
            assert torch.equal(b.hi, ref.hi) and torch.equal(b.lo, ref.lo), (nx, steps)
            if steps <= 2:
                tile = fk.FlatTile(info["rows"], info["width"])
                blocked = fdk.temporal_reference_blocked(a.hi, a.lo, solid, cfg, exact, steps,
                                                         tile)
                assert torch.equal(blocked.hi, ref.hi) and torch.equal(blocked.lo, ref.lo)
        deepest = info["max_steps"]
        assert (fdk.TEMPORAL_LAUNCHES, fdk.TEMPORAL_STEPS, fdk.LAUNCHES) == (
            before[0] + deepest, before[1] + deepest * (deepest + 1) // 2, before[2])


@pytest.mark.cuda
def test_cuda_ds64_counts_launches_per_form(cuda_device):
    """cuda-ds64 at 24x40: 10 steps in passes of 4, 4 and 2 of the temporal
    form, bitwise equal to a temporal=1 session's 10 one-step launches; at
    24x38 (NY no multiple of 4), and in an exact-tier session, every step a
    one-step launch."""
    cfg, walls = _scene("column0", np.float64)
    f0 = df64.to_f64(_perturbed_pair(cfg, "cpu"))
    before = (fdk.LAUNCHES, fdk.TEMPORAL_LAUNCHES, fdk.TEMPORAL_STEPS)
    sim = Simulation(cfg, walls, backend="cuda-ds64", f0=f0).run(10)
    assert sim._session.temporal == fdk.DS_TEMPORAL
    assert (fdk.LAUNCHES, fdk.TEMPORAL_LAUNCHES, fdk.TEMPORAL_STEPS) == (
        before[0], before[1] + 3, before[2] + 10)
    one = fdk.Session(cfg, walls, device=cuda_device, temporal=1)
    one.load(df64.from_f64(f0, cuda_device))
    one.advance(10)
    assert fdk.LAUNCHES == before[0] + 10
    np.testing.assert_array_equal(sim.state(), df64.to_f64(one.state()))
    cfg38 = LatticeConfig(nx=24, ny=38, dtype=np.float64, accel=0.005)
    before = (fdk.LAUNCHES, fdk.TEMPORAL_LAUNCHES)
    sim = Simulation(cfg38, geometry.channel(24, 38), backend="cuda-ds64").run(5)
    assert sim._session.temporal == 1
    assert (fdk.LAUNCHES, fdk.TEMPORAL_LAUNCHES) == (before[0] + 5, before[1])
    exact = fdk.Session(cfg, walls, device=cuda_device, exact=True)
    exact.load(df64.from_f64(f0, cuda_device))
    exact.advance(5)
    assert exact.temporal == 1
    assert (fdk.LAUNCHES, fdk.TEMPORAL_LAUNCHES) == (before[0] + 10, before[1])


@pytest.mark.cuda
def test_ds_temporal_form_refuses_on_the_card(cuda_device):
    """A buffer 4 bytes off a 16-byte boundary, and a pass one step deeper
    than the tile takes: ValueError and no launch, nothing in their place;
    a session deeper than the tile takes is refused when it is built."""
    cfg, a, solid = _ds_temporal_scene(16, 40, cuda_device)
    n = a.hi.numel()
    off = torch.empty(n + 1, dtype=torch.float32, device=cuda_device)[1:].view_as(a.hi)
    dst = df64.DS(torch.empty_like(a.hi), torch.empty_like(a.lo))
    before = (fdk.TEMPORAL_LAUNCHES, fdk.LAUNCHES)
    with pytest.raises(ValueError, match="aligned"):
        fdk.temporal_step(df64.DS(off, a.lo), dst, solid, cfg, 2, has_walls=True)
    with pytest.raises(ValueError, match="aligned"):
        fdk.temporal_step(a, df64.DS(dst.hi, off), solid, cfg, 2, has_walls=True)
    deepest = fdk.temporal_info(False, True)["max_steps"]
    for exact in (False, True):
        with pytest.raises(ValueError, match="no output tile"):
            fdk.temporal_step(a, dst, solid, cfg, deepest + 1, has_walls=True, exact=exact)
    with pytest.raises(ValueError, match="no output tile"):
        fdk.Session(cfg, solid.cpu().numpy() == 1, device=cuda_device, temporal=deepest + 1)
    assert (fdk.TEMPORAL_LAUNCHES, fdk.LAUNCHES) == before


def _shard_planes(plane, n, device):
    """A host class plane as each shard's ShardPlane (class plane and
    halo class rows) on `device`."""
    t = torch.as_tensor(plane, device=device)
    L = t.shape[0] // n
    return [fk.ShardPlane(t[k * L:(k + 1) * L].contiguous(), t[(k * L - 1) % t.shape[0]].contiguous(),
                          t[(k * L + L) % t.shape[0]].contiguous()) for k in range(n)]


def _geometry_source(kind, cfg, walls):
    """None, a host class plane (walls or slip codes) or a wall spec."""
    if kind == "none":
        return None
    if kind == "plane":
        return walls.astype(np.uint8)
    if kind == "slip":
        w, sx, sy = _slip_scene(cfg.nx, cfg.ny)
        return fk.class_plane(w, sx, sy)
    return geometry.infer_spec(walls)


def _ext_steps(cfg, geom, n, device, steps=5, fast_math=False, form=None, fused=False):
    """`steps` steps of the ext-halo kernel over n virtual shards (interior
    and edge launches, or with fused one launch per shard) in `form`
    (default: the one kernel_form names), each shard held bitwise against
    step_reference_ext from the same input, and the wide form also against
    step_reference_ext_wide; returns the joined state."""
    f = _perturbed(cfg, device)
    L = cfg.nx // n
    geoms = _shard_planes(geom, n, device) if isinstance(geom, np.ndarray) else [geom] * n
    before = fk.EXT_LAUNCHES
    forms = dict(fk.EXT_FORM_LAUNCHES)
    for _ in range(steps):
        shards = [f[:, k * L:(k + 1) * L].contiguous() for k in range(n)]
        outs = []
        for k in range(n):
            halo = (shards[(k - 1) % n][:, -1].contiguous(), shards[(k + 1) % n][:, 0].contiguous())
            dst = torch.full_like(shards[k], float("nan"))
            kw = dict(row_offset=k * L, fast_math=fast_math, form=form)
            if fused:
                fk.ext_launcher(shards[k], dst, halo, geoms[k], cfg, **kw)()
            else:
                fk.ext_launcher(shards[k], dst, None, geoms[k], cfg, row0=1, rows=L - 2, **kw)()
                for r in (0, L - 1):
                    fk.ext_launcher(shards[k], dst, halo, geoms[k], cfg, row0=r, rows=1, **kw)()
            ref = fk.step_reference_ext(shards[k], halo, geoms[k], cfg, row_offset=k * L)
            torch.cuda.synchronize()
            if not fast_math:
                assert torch.equal(dst, ref)
                if form == "wide":
                    assert torch.equal(dst, fk.step_reference_ext_wide(
                        shards[k], halo, geoms[k], cfg, fk.WIDE_COLUMNS[dst.dtype],
                        row_offset=k * L))
            outs.append(dst)
        f = torch.cat(outs, dim=1)
    launches = steps * (1 if fused else 3) * n
    assert fk.EXT_LAUNCHES == before + launches
    if form is not None:
        assert fk.EXT_FORM_LAUNCHES[form] == forms.get(form, 0) + launches
    return f


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("geom", ["none", "plane", "spec", "slip", "bf16-spec"])
def test_ext_kernel_equals_step_reference_ext(geom, n, cuda_device):
    cfg, walls = _scene("column0", "bfloat16" if geom == "bf16-spec" else np.float32)
    _ext_steps(cfg, _geometry_source(geom.removeprefix("bf16-"), cfg, walls), n, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("geom", ["none", "plane", "spec", "slip", "bf16-spec", "bf16-plane"])
def test_ext_kernel_forms_equal_their_plain_versions_and_each_other(geom, n, cuda_device):
    """Both forms of the ext-halo kernel at the three small scenes, both
    schedules (interior + edges, one launch per shard): each bitwise
    against step_reference_ext (the wide one also against
    step_reference_ext_wide), and so against the other."""
    dtype = "bfloat16" if geom.startswith("bf16") else np.float32
    for name in ("barrier", "column0", "empty"):
        cfg, walls = _scene(name, dtype)
        g = _geometry_source(geom.removeprefix("bf16-"), cfg, walls)
        for fused in (False, True):
            outs = [_ext_steps(cfg, g, n, cuda_device, steps=3, form=form, fused=fused)
                    for form in fk.FORMS]
            assert torch.equal(*outs)


@pytest.mark.cuda
@pytest.mark.parametrize("form", fk.FORMS)
def test_ext_and_rdma_forms_fast_math_within_tolerance(form, cuda_device):
    cfg = LatticeConfig(nx=48, ny=96, dtype=np.float32)
    spec = geometry.infer_spec(_plate_48x96())
    ref = _perturbed(cfg, cuda_device)
    for _ in range(fk.FAST_MATH_STEPS):
        ref = fk.step_reference(ref, None, cfg, wall_spec=spec)
    for got in (_ext_steps(cfg, spec, 4, cuda_device, steps=fk.FAST_MATH_STEPS, fast_math=True,
                           form=form),
                _rdma_steps(cfg, spec, 4, cuda_device, steps=fk.FAST_MATH_STEPS, fast_math=True,
                            form=form)):
        assert float(((got - ref).abs() / ref.abs()).max()) <= fk.FAST_MATH_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_ext_and_rdma_forms_follow_the_pointers_on_the_card(dtype, cuda_device):
    """The form a sharded launch takes, by shape and pointer: wide for
    aligned buffers whose NY the storage's column count divides, narrow
    for a halo row at an odd offset, for unaligned comm rows and for an NY
    it does not divide; the counts follow, and form="wide" raises where
    the rule does not hold."""
    cfg, walls = _scene("column0", dtype)
    f = _perturbed(cfg, cuda_device)
    src, dst = f[:, :12].contiguous(), torch.empty_like(f[:, :12])
    halo = (f[:, -1].contiguous(), f[:, 12].contiguous())
    assert fk.ext_launcher(src, dst, halo, None, cfg).form == "wide"
    odd = torch.empty(halo[0].numel() + 1, dtype=src.dtype, device=cuda_device)[1:].view(9, cfg.ny)
    odd.copy_(halo[0])
    call = fk.ext_launcher(src, dst, (odd, halo[1]), None, cfg)
    before = dict(fk.EXT_FORM_LAUNCHES)
    call()
    assert call.form == "narrow" and fk.EXT_FORM_LAUNCHES["narrow"] == before.get("narrow", 0) + 1
    torch.cuda.synchronize()
    assert torch.equal(dst, fk.step_reference_ext(src, (odd, halo[1]), None, cfg))
    with pytest.raises(ValueError, match="form"):
        fk.ext_launcher(src, dst, (odd, halo[1]), None, cfg, form="wide")
    end = fk.rdma_end(cfg, cuda_device)
    assert fk.rdma_launcher(src, dst, end, end, end, None, cfg).form == "wide"
    rows = torch.empty(end.top.numel() + 1, dtype=src.dtype, device=cuda_device)[1:]
    bad = end._replace(top=rows.view(end.top.shape))
    assert fk.rdma_launcher(src, dst, bad, end, end, None, cfg).form == "narrow"
    with pytest.raises(ValueError, match="form"):
        fk.rdma_launcher(src, dst, bad, end, end, None, cfg, form="wide")
    cfg6 = LatticeConfig(nx=24, ny=36, dtype=dtype)  # 36 % 8 != 0: narrow in bf16 only
    g = _perturbed(cfg6, cuda_device)
    s6 = g[:, :12].contiguous()
    want = "wide" if dtype == np.float32 else "narrow"
    assert fk.ext_launcher(s6, torch.empty_like(s6), None, None, cfg6, row0=1, rows=10).form == want
    e6 = fk.rdma_end(cfg6, cuda_device)
    assert fk.rdma_launcher(s6, torch.empty_like(s6), e6, e6, e6, None, cfg6).form == want


@pytest.mark.cuda
def test_ext_kernel_fast_math_within_its_tolerance(cuda_device):
    cfg = LatticeConfig(nx=48, ny=96, dtype=np.float32)
    spec = geometry.infer_spec(_plate_48x96())
    got = _ext_steps(cfg, spec, 4, cuda_device, steps=fk.FAST_MATH_STEPS, fast_math=True)
    ref = _perturbed(cfg, cuda_device)
    for _ in range(fk.FAST_MATH_STEPS):
        ref = fk.step_reference(ref, None, cfg, wall_spec=spec)
    assert float(((got - ref).abs() / ref.abs()).max()) <= fk.FAST_MATH_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
def test_ds_ext_kernel_equals_step_reference_ext(exact, cuda_device):
    cfg, walls = _scene("column0", np.float64)
    n, L = 4, cfg.nx // 4
    a = _perturbed_pair(cfg, cuda_device)
    planes = _shard_planes(walls.astype(np.uint8), n, cuda_device)
    before = fdk.EXT_LAUNCHES
    for _ in range(5):
        sh = [df64.DS(a.hi[:, k * L:(k + 1) * L].contiguous(), a.lo[:, k * L:(k + 1) * L].contiguous())
              for k in range(n)]
        outs = []
        for k in range(n):
            p, q = sh[(k - 1) % n], sh[(k + 1) % n]
            halo = (df64.DS(p.hi[:, -1].contiguous(), p.lo[:, -1].contiguous()),
                    df64.DS(q.hi[:, 0].contiguous(), q.lo[:, 0].contiguous()))
            dst = df64.DS(torch.empty_like(sh[k].hi), torch.empty_like(sh[k].lo))
            fdk.ext_launcher(sh[k], dst, None, planes[k], cfg, has_walls=True, exact=exact,
                             row0=1, rows=L - 2)()
            for r in (0, L - 1):
                fdk.ext_launcher(sh[k], dst, halo, planes[k], cfg, has_walls=True, exact=exact,
                                 row0=r, rows=1)()
            ref = fdk.step_reference_ext(sh[k].hi, sh[k].lo, halo, planes[k], cfg, exact)
            torch.cuda.synchronize()
            assert torch.equal(dst.hi, ref.hi) and torch.equal(dst.lo, ref.lo)
            outs.append(dst)
        a = df64.DS(torch.cat([o.hi for o in outs], 1), torch.cat([o.lo for o in outs], 1))
    assert fdk.EXT_LAUNCHES == before + 5 * 3 * n


@pytest.mark.cuda
def test_sharded_cuda_equals_cuda_bitwise(cuda_device, monkeypatch):
    """sharded-cuda over 4 virtual shards of the card, 20 steps, against
    the cuda backend; the same for sharded-cuda-ds64 against cuda-ds64."""
    from latticeboltzmann_tpu_torch.models import engine

    mesh = sharded.make_mesh(devices=[cuda_device] * 4)
    monkeypatch.setitem(engine._BACKENDS, "sharded-cuda", sharded.make_cuda_backend(mesh))
    monkeypatch.setitem(engine._BACKENDS, "sharded-cuda-ds64", sharded.make_cuda_ds_backend(mesh))
    cfg, walls = _scene("column0")
    before = (fk.EXT_LAUNCHES, fk.EXT_TEMPORAL_VARIANT_LAUNCHES["f32-spec"],
              fk.EXT_TEMPORAL_STEPS)
    out = Simulation(cfg, walls, backend="sharded-cuda").run(20).state()
    # 7 passes: 6 of 3 steps, one launch per 6-row shard (fewer than 2 T + 1
    # rows), and one of 2, the interior and two 2-row bands of each shard;
    # no one-step launch
    assert (fk.EXT_LAUNCHES, fk.EXT_TEMPORAL_VARIANT_LAUNCHES["f32-spec"],
            fk.EXT_TEMPORAL_STEPS) == (before[0], before[1] + 6 * 4 + 3 * 4,
                                       before[2] + 6 * 3 * 4 + 2 * 3 * 4)
    np.testing.assert_array_equal(out, Simulation(cfg, walls, backend="cuda").run(20).state())
    cfg, walls = _scene("column0", np.float64)
    before = (fdk.EXT_LAUNCHES, fdk.EXT_TEMPORAL_LAUNCHES, fdk.EXT_TEMPORAL_STEPS)
    out = Simulation(cfg, walls, backend="sharded-cuda-ds64").run(20).state()
    # 5 passes of 4 steps, one launch per 6-row shard (fewer than 2 T + 1 rows)
    assert (fdk.EXT_LAUNCHES, fdk.EXT_TEMPORAL_LAUNCHES, fdk.EXT_TEMPORAL_STEPS) == (
        before[0], before[1] + 5 * 4, before[2] + 20 * 4)
    np.testing.assert_array_equal(out, Simulation(cfg, walls, backend="cuda-ds64").run(20).state())


@pytest.mark.cuda
def test_sharded_paths_across_cards_equal_single_chip(cuda_device, monkeypatch):
    """Over a mesh of the cards, and of the cards each twice (shards of
    one card interleaved with another's), the halo rows cross cards on
    each card's copy stream: sharded-cuda (both schedules),
    sharded-cuda-ds64 and the eager sharded backend equal the single-chip
    backends after 20 steps, bitwise."""
    from latticeboltzmann_tpu_torch.models import engine

    n = max((k for k in range(2, torch.cuda.device_count() + 1) if 24 % k == 0), default=0)
    if not n:
        pytest.skip("needs two or more CUDA cards")
    cards = [torch.device("cuda", i) for i in range(n)]
    for devices in (cards, cards * 2 if 24 % (2 * n) == 0 else cards):
        mesh = sharded.make_mesh(devices=devices)
        cfg, walls = _scene("column0")
        want = Simulation(cfg, walls, backend="cuda").run(20).state()
        for overlap in (True, False):
            monkeypatch.setitem(engine._BACKENDS, "sharded-cuda",
                                sharded.make_cuda_backend(mesh, overlap=overlap))
            out = Simulation(cfg, walls, backend="sharded-cuda").run(20).state()
            np.testing.assert_array_equal(out, want)
        monkeypatch.setitem(engine._BACKENDS, "sharded", sharded.make_backend(mesh))
        ref = Simulation(cfg, walls, backend="torch", device=cuda_device).run(20).state()
        np.testing.assert_array_equal(
            Simulation(cfg, walls, backend="sharded", device=cuda_device).run(20).state(), ref)
        cfg, walls = _scene("column0", np.float64)
        monkeypatch.setitem(engine._BACKENDS, "sharded-cuda-ds64",
                            sharded.make_cuda_ds_backend(mesh))
        out = Simulation(cfg, walls, backend="sharded-cuda-ds64").run(20).state()
        np.testing.assert_array_equal(
            out, Simulation(cfg, walls, backend="cuda-ds64").run(20).state())


class _RdmaRing:
    """n virtual shards of the card wired for the rdma kernel: two buffers
    per shard, an RdmaEnd and a stream each, a launch per shard and buffer
    parity."""

    def __init__(self, cfg, geom, n, device, fast_math=False, timeout_s=1.0, form=None):
        f = _perturbed(cfg, device)
        L = cfg.nx // n
        self.n = n
        self.geoms = _shard_planes(geom, n, device) if isinstance(geom, np.ndarray) else [geom] * n
        self.bufs = [[f[:, k * L:(k + 1) * L].contiguous() for k in range(n)]]
        self.bufs.append([torch.empty_like(b) for b in self.bufs[0]])
        self.ends = [fk.rdma_end(cfg, device) for _ in range(n)]
        self.streams = [torch.cuda.Stream(device) for _ in range(n)]
        self.launches = [[fk.rdma_launcher(
            self.bufs[p][k], self.bufs[1 - p][k], self.ends[k], self.ends[(k - 1) % n],
            self.ends[(k + 1) % n], self.geoms[k], cfg, row_offset=k * L, fast_math=fast_math,
            timeout_s=timeout_s, stream=self.streams[k], form=form) for k in range(n)]
            for p in range(2)]
        self.parity = self.step = 0
        torch.cuda.synchronize()

    def advance(self, only=None):
        self.step += 1
        for k, launch in enumerate(self.launches[self.parity]):
            if only is None or k in only:
                launch(self.step)
        self.parity ^= 1
        torch.cuda.synchronize()
        return [fk.rdma_timed_out(e) for e in self.ends]


def _rdma_steps(cfg, geom, n, device, steps=5, fast_math=False, form=None):
    """`steps` steps of the rdma kernel over n virtual shards in `form`
    (default: the one kernel_form names), one launch per shard and step,
    each shard's block, comm rows and flags held bitwise against
    step_reference_rdma from the same inputs, and the wide form's blocks
    also against its plain version; returns the joined state."""
    ring = _RdmaRing(cfg, geom, n, device, fast_math=fast_math, form=form)
    ref_ends = [fk.rdma_end(cfg, device) for _ in range(n)]
    before = fk.RDMA_LAUNCHES
    forms = dict(fk.RDMA_FORM_LAUNCHES)
    for step in range(1, steps + 1):
        srcs, dsts = ring.bufs[ring.parity], ring.bufs[1 - ring.parity]
        assert ring.advance() == [0] * n
        refs = fk.step_reference_rdma(srcs, ref_ends, ring.geoms, cfg, step)
        for k in range(n):
            for got, want in zip(ring.ends[k][:3], ref_ends[k][:3]):  # top, bot, flags
                assert torch.equal(got, want)
            if not fast_math:
                assert torch.equal(dsts[k], refs[k])
                if form == "wide":
                    assert torch.equal(dsts[k], fk.rdma_compute_reference(
                        srcs[k], ref_ends[k], ring.geoms[k], cfg, step,
                        row_offset=k * (cfg.nx // n), form="wide"))
    assert fk.RDMA_LAUNCHES == before + steps * n
    if form is not None:
        assert fk.RDMA_FORM_LAUNCHES[form] == forms.get(form, 0) + steps * n
    return torch.cat(ring.bufs[ring.parity], dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("geom", ["none", "plane", "spec", "slip", "bf16-spec"])
def test_rdma_kernel_equals_step_reference_rdma(geom, n, cuda_device):
    cfg, walls = _scene("column0", "bfloat16" if geom == "bf16-spec" else np.float32)
    _rdma_steps(cfg, _geometry_source(geom.removeprefix("bf16-"), cfg, walls), n, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("geom", ["none", "plane", "spec", "slip", "bf16-spec", "bf16-plane"])
def test_rdma_kernel_forms_equal_their_plain_versions_and_each_other(geom, n, cuda_device):
    """Both forms of the rdma kernel at the three small scenes: each
    bitwise against step_reference_rdma, comm rows and flags included (the
    wide one also against its plain version), and so against the other."""
    dtype = "bfloat16" if geom.startswith("bf16") else np.float32
    for name in ("barrier", "column0", "empty"):
        cfg, walls = _scene(name, dtype)
        g = _geometry_source(geom.removeprefix("bf16-"), cfg, walls)
        outs = [_rdma_steps(cfg, g, n, cuda_device, steps=3, form=form) for form in fk.FORMS]
        assert torch.equal(*outs)


@pytest.mark.cuda
def test_sharded_paths_count_their_launches_by_form(cuda_device, monkeypatch):
    """sharded-cuda and sharded-cuda-rdma at temporal=1 (the one-step
    forms) over 4 virtual shards at 24x40: the rdma launches and
    sharded-cuda's interior launches take the wide form, sharded-cuda's
    one-row launches the narrow one (the launcher's default); at 24x38 (38
    % 4 != 0) every launch is narrow. Every launch counted by form, bitwise
    equal to the cuda backend."""
    from latticeboltzmann_tpu_torch.models import engine

    mesh = sharded.make_mesh(devices=[cuda_device] * 4)
    for ny, wide in ((40, True), (38, False)):
        cfg = LatticeConfig(nx=24, ny=ny, dtype=np.float32, accel=0.005)
        walls = geometry.channel(24, ny)
        walls[8:14, 0:3] = True
        want = Simulation(cfg, walls, backend="cuda").run(20).state()
        for backend, rdma, counts, expected in (
                ("sharded-cuda", False, fk.EXT_FORM_LAUNCHES,
                 {"wide": 4, "narrow": 8} if wide else {"narrow": 12}),
                ("sharded-cuda-rdma", True, fk.RDMA_FORM_LAUNCHES,
                 {"wide" if wide else "narrow": 4})):
            monkeypatch.setitem(engine._BACKENDS, backend,
                                sharded.make_cuda_backend(mesh, rdma=rdma, temporal=1))
            before = dict(counts)
            sim = Simulation(cfg, walls, backend=backend, allow_experimental=True)
            np.testing.assert_array_equal(sim.run(20).state(), want)
            assert {k: v - before.get(k, 0) for k, v in counts.items() if v != before.get(k, 0)} \
                == {form: 20 * n for form, n in expected.items()}


@pytest.mark.cuda
def test_rdma_kernel_fast_math_within_its_tolerance(cuda_device):
    cfg = LatticeConfig(nx=48, ny=96, dtype=np.float32)
    spec = geometry.infer_spec(_plate_48x96())
    got = _rdma_steps(cfg, spec, 4, cuda_device, steps=fk.FAST_MATH_STEPS, fast_math=True)
    ref = _perturbed(cfg, cuda_device)
    for _ in range(fk.FAST_MATH_STEPS):
        ref = fk.step_reference(ref, None, cfg, wall_spec=spec)
    assert float(((got - ref).abs() / ref.abs()).max()) <= fk.FAST_MATH_RTOL


@pytest.mark.cuda
def test_rdma_withheld_send_raises_and_does_not_hang(cuda_device):
    """One shard of a ring of two launched alone: its edge rows wait for
    rows that never come, give up after the timeout and leave the step in
    the shard's error word; later launches of that shard skip their waits.
    Through the session the same ends in a raised RuntimeError."""
    import time

    cfg, walls = _scene("empty")
    ring = _RdmaRing(cfg, None, 2, cuda_device, timeout_s=0.2)
    t0 = time.perf_counter()
    assert ring.advance(only={0}) == [1, 0]
    assert 0.2 <= time.perf_counter() - t0 < 3.0
    t0 = time.perf_counter()
    for _ in range(10):
        assert ring.advance(only={0}) == [1, 0]
    assert time.perf_counter() - t0 < 0.2

    sess = sharded.ShardedRdmaSession(cfg, walls, mesh=sharded.make_mesh(devices=[cuda_device] * 2),
                                      timeout_s=0.2)
    sess.load(_perturbed(cfg, cuda_device))
    (_, calls), = sess._plans[sess._parity]
    calls[0](1)  # shard 0 only
    with pytest.raises(RuntimeError, match="gave up"):
        sess.block()
    with pytest.raises(RuntimeError, match="gave up"):
        sess.state()
    sess.load(_perturbed(cfg, cuda_device))  # a load clears the error
    sess.advance(3)
    sess.block()


@pytest.mark.cuda
def test_sharded_cuda_rdma_equals_cuda_bitwise(cuda_device, monkeypatch):
    """sharded-cuda-rdma over 2 and 4 virtual shards of the card, 20 steps,
    against the cuda backend: 2 shards of 12 rows in passes of 3 (7 passes,
    one counted launch of the rdma temporal form per shard and pass), 4
    shards of 6 rows (fewer than 2 T + 1) one counted launch of the
    one-step rdma form per shard and step; no halo copy from the host; a
    session that loads twice starts its flags again."""
    from latticeboltzmann_tpu_torch.models import engine

    cfg, walls = _scene("column0")
    want = Simulation(cfg, walls, backend="cuda").run(20).state()
    for n, launches in ((2, 7), (4, 20)):
        mesh = sharded.make_mesh(devices=[cuda_device] * n)
        monkeypatch.setitem(engine._BACKENDS, "sharded-cuda-rdma",
                            sharded.make_cuda_backend(mesh, rdma=True))
        with pytest.raises(RuntimeError, match="allow_experimental=True"):
            Simulation(cfg, walls, backend="sharded-cuda-rdma")
        counts = fk.RDMA_TEMPORAL_VARIANT_LAUNCHES if n == 2 else fk.RDMA_VARIANT_LAUNCHES
        before, copies = counts["f32-spec"], sharded.HALO_COPIES
        sim = Simulation(cfg, walls, backend="sharded-cuda-rdma", allow_experimental=True)
        np.testing.assert_array_equal(sim.run(20).state(), want)
        assert counts["f32-spec"] == before + launches * n
        assert sharded.HALO_COPIES == copies
        sess = sim._session
        assert sess.temporal == (3 if n == 2 else 1)
        assert sess.step == launches and all(e.flags.tolist() == [launches] * 2
                                             for e in sess._ends)
        sim.f = torch.as_tensor(initial_state(cfg), device=cuda_device)  # a second load
        assert sess.step == 0 and all(e.flags.tolist() == [0, 0] for e in sess._ends)
        np.testing.assert_array_equal(sim.run(20).state(), want)


@pytest.mark.cuda
def test_rdma_path_across_cards_equals_single_chip(cuda_device, monkeypatch):
    """Over a mesh of the cards, and of the cards each twice, the kernels
    write their neighbours' comm rows and flags through peer pointers:
    equal to the cuda backend after 20 steps, bitwise."""
    from latticeboltzmann_tpu_torch.models import engine

    n = max((k for k in range(2, torch.cuda.device_count() + 1) if 24 % k == 0), default=0)
    if not n:
        pytest.skip("needs two or more CUDA cards")
    cards = [torch.device("cuda", i) for i in range(n)]
    cfg, walls = _scene("column0")
    want = Simulation(cfg, walls, backend="cuda").run(20).state()
    for devices in (cards, cards * 2 if 24 % (2 * n) == 0 else cards):
        monkeypatch.setitem(engine._BACKENDS, "sharded-cuda-rdma",
                            sharded.make_cuda_backend(sharded.make_mesh(devices=devices), rdma=True))
        sim = Simulation(cfg, walls, backend="sharded-cuda-rdma", allow_experimental=True)
        np.testing.assert_array_equal(sim.run(20).state(), want)


def _rows_mod(x, a, b):
    """Rows [a, b) of x along dim -2, modulo its rows, contiguous."""
    idx = torch.tensor([r % x.shape[-2] for r in range(a, b)], device=x.device)
    return x.index_select(x.dim() - 2, idx).contiguous()


def _pass_shard(f, geom, n, k, depth):
    """Shard k of a ring of n over the card's state f: (block, (top, bot)
    halo blocks of `depth` rows, geometry with (depth, NY) class rows)."""
    L = f.shape[1] // n
    r0 = k * L
    halo = (_rows_mod(f, r0 - depth, r0), _rows_mod(f, r0 + L, r0 + L + depth))
    if torch.is_tensor(geom):
        geom = fk.ShardPlane(_rows_mod(geom, r0, r0 + L), _rows_mod(geom, r0 - depth, r0),
                             _rows_mod(geom, r0 + L, r0 + L + depth))
    return _rows_mod(f, r0, r0 + L), halo, geom


def _on_card_geometry(kind, cfg, walls, device):
    g = _geometry_source(kind, cfg, walls)
    return torch.as_tensor(g, device=device) if isinstance(g, np.ndarray) else g


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("geom", ["none", "plane", "spec", "slip", "bf16-spec", "bf16-slip"])
def test_ext_temporal_kernel_equals_its_plain_versions(geom, n, cuda_device):
    """The ext-halo temporal form on each shard of a ring of n (column0,
    24x40), halos of 4 rows: one pass at every L 1-4 over the whole shard,
    the two L-row bands and the interior, at the launch's planned tile and
    at a forced tile of 2 L + 1 rows, bitwise against
    temporal_reference_ext (and so against the local chain), and against
    temporal_reference_ext_blocked at the planned tile; one pass of the
    deepest L the tile takes on a ring of one, halos of that depth. Every
    launch counted in EXT_TEMPORAL_LAUNCHES."""
    dtype = "bfloat16" if geom.startswith("bf16") else np.float32
    cfg, walls = _scene("column0", dtype)
    g = _on_card_geometry(geom.removeprefix("bf16-"), cfg, walls, cuda_device)
    f = _perturbed(cfg, cuda_device)
    info = fk.temporal_info(fk._storage(cfg), device=cuda_device, ext=True)
    tile = fk.FlatTile(info["rows"], info["width"])
    Ls = 24 // n
    before = fk.EXT_TEMPORAL_LAUNCHES
    launches = 0
    depths = [(L, 4) for L in range(1, 5)] + ([(info["max_steps"],) * 2] if n == 1 else [])
    for L, depth in depths:
        want = fk.temporal_reference(f, g, cfg, L)
        for k in range(n):
            src, halo, gk = _pass_shard(f, g, n, k, depth)
            ranges = [(0, Ls)] + ([(L, Ls - 2 * L), (0, L), (Ls - L, L)] if Ls > 2 * L else [])
            for (row0, rows), tile_rows in itertools.product(ranges, (None, 2 * L + 1)):
                dst = torch.full_like(src, float("nan"))
                go = fk.ext_temporal_launcher(src, dst, halo, gk, cfg, L, row0=row0, rows=rows,
                                              row_offset=k * Ls, tile_rows=tile_rows)
                assert go.plan["rows"] == tile_rows or (tile_rows is None
                                                        and go.plan["rows"] <= tile.rows)
                go()
                launches += 1
                torch.cuda.synchronize()
                assert torch.equal(dst[:, row0:row0 + rows],
                                   want[:, k * Ls + row0:k * Ls + row0 + rows]), (L, k, row0)
                if depth == 4 and row0 == 0 and rows == Ls and tile_rows is None:
                    assert torch.equal(dst, fk.temporal_reference_ext_blocked(
                        src, halo, gk, cfg, L, fk.FlatTile(go.plan["rows"], tile.width),
                        row_offset=k * Ls))
    assert fk.EXT_TEMPORAL_LAUNCHES == before + launches


class _RdmaPassRing:
    """n virtual shards of the card wired for the rdma temporal form as
    ShardedRdmaSession wires them: two buffers a shard, a temporal RdmaEnd
    of depth T and a stream each, a launch per shard, parity and pass
    depth."""

    def __init__(self, cfg, geom, n, T, device, fast_math=False, timeout_s=1.0, tile_rows=None):
        f = _perturbed(cfg, device)
        self.n, self.L, self.cfg = n, cfg.nx // n, cfg
        self.shards = [_pass_shard(f, geom, n, k, T) for k in range(n)]
        self.geoms = [s[2] for s in self.shards]
        self.bufs = [[s[0] for s in self.shards], [torch.empty_like(s[0]) for s in self.shards]]
        self.ends = [fk.rdma_end(cfg, device, depth=T) for _ in range(n)]
        self.streams = [torch.cuda.Stream(device) for _ in range(n)]
        self.options = dict(fast_math=fast_math, timeout_s=timeout_s, tile_rows=tile_rows)
        self.launches = {}
        self.parity = self.passes = 0
        torch.cuda.synchronize()

    def launch(self, k, steps):
        key = (self.parity, k, steps)
        if key not in self.launches:
            n = self.n
            self.launches[key] = fk.rdma_temporal_launcher(
                self.bufs[self.parity][k], self.bufs[1 - self.parity][k], self.ends[k],
                self.ends[(k - 1) % n], self.ends[(k + 1) % n], self.geoms[k], self.cfg, steps,
                card_shards=n, row_offset=k * self.L, stream=self.streams[k], **self.options)
        return self.launches[key]

    def advance(self, steps, only=None):
        self.passes += 1
        for st in self.streams:
            st.wait_stream(torch.cuda.current_stream())
        for k in range(self.n):
            if only is None or k in only:
                self.launch(k, steps)(self.passes)
        self.parity ^= 1
        torch.cuda.synchronize()
        return [fk.rdma_timed_out(e) for e in self.ends]


@pytest.mark.cuda
@pytest.mark.parametrize("tile", ["planned", "forced"])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("geom", ["none", "plane", "spec", "slip", "bf16-spec", "bf16-plane"])
def test_rdma_temporal_kernel_equals_its_plain_version(geom, n, tile, cuda_device):
    """The rdma temporal form over a ring of n virtual shards of 48x40, each
    shard on a stream of its own, at each launch's planned tile or at a
    forced tile of 2 T + 1 rows: passes of T, T, 1, T (T =
    SHARDED_TEMPORAL), every shard's block, comm blocks and flags bitwise
    against temporal_reference_rdma from the same inputs (at the forced
    tile its blocked form), the launch words back at zero after each pass;
    one counted launch per shard and pass."""
    dtype = "bfloat16" if geom.startswith("bf16") else np.float32
    cfg = LatticeConfig(nx=48, ny=40, dtype=dtype, accel=0.005)
    walls = geometry.channel(48, 40)
    walls[20:26, 0:3] = True
    T = sharded.SHARDED_TEMPORAL[fk._storage(cfg)]
    g = _on_card_geometry(geom.removeprefix("bf16-"), cfg, walls, cuda_device)
    tile_rows = 2 * T + 1 if tile == "forced" else None
    ring = _RdmaPassRing(cfg, g, n, T, cuda_device, tile_rows=tile_rows)
    ref_ends = [fk.rdma_end(cfg, cuda_device, depth=T) for _ in range(n)]
    before = fk.RDMA_TEMPORAL_LAUNCHES
    passes = (T, T, 1, T)
    for p, steps in enumerate(passes, 1):
        srcs = [b.clone() for b in ring.bufs[ring.parity]]
        assert ring.advance(steps) == [0] * n
        assert ring.launch(0, steps).plan["rows"] == tile_rows or tile_rows is None
        refs = fk.temporal_reference_rdma(
            srcs, ref_ends, ring.geoms, cfg, steps, p,
            tile=None if tile_rows is None else fk.FlatTile(tile_rows, fk.TILE_WIDTH))
        for k in range(n):
            assert torch.equal(ring.bufs[ring.parity][k], refs[k]), (p, k)
            for got, want in zip(ring.ends[k][:3], ref_ends[k][:3]):  # top, bot, flags
                assert torch.equal(got, want), (p, k)
            assert not ring.ends[k].work.any()
    assert fk.RDMA_TEMPORAL_LAUNCHES == before + len(passes) * n


@pytest.mark.cuda
def test_shard_temporal_forms_fast_math_within_tolerance(cuda_device):
    """Both shard forms' fast-math variants (rcp.approx) after
    FAST_MATH_STEPS steps in passes of 3 over 4 virtual shards of 48x96,
    within FAST_MATH_RTOL of the IEEE chain."""
    cfg = LatticeConfig(nx=48, ny=96, dtype=np.float32)
    spec = geometry.infer_spec(_plate_48x96())
    f = _perturbed(cfg, cuda_device)
    ref = fk.temporal_reference(f, spec, cfg, fk.FAST_MATH_STEPS)
    mesh = sharded.make_mesh(devices=[cuda_device] * 4)
    for rdma in (False, True):
        sess = (sharded.ShardedRdmaSession(cfg, _plate_48x96(), mesh=mesh, wall_spec=spec,
                                           fast_math=True) if rdma else
                sharded.ShardedSession(cfg, _plate_48x96(), mesh=mesh, wall_spec=spec,
                                       fast_math=True))
        assert sess.temporal == 3
        sess.load(f)
        sess.advance(fk.FAST_MATH_STEPS)
        got = sess.state()
        assert float(((got - ref).abs() / ref.abs()).max()) <= fk.FAST_MATH_RTOL


@pytest.mark.cuda
def test_shard_temporal_forms_refuse_on_the_card(cuda_device):
    """On the card the wrappers refuse a misaligned buffer, a pass deeper
    than the card's tile takes and a ring too large for the card's slots
    (no edge CTA could spin with one slot to spare), and the entry points
    themselves refuse a pass deeper than the halos: ValueError or a
    refused launch, never another form in their place."""
    cfg, _ = _scene("column0")
    f = _perturbed(cfg, cuda_device)
    src, halo, _ = _pass_shard(f, None, 2, 0, 3)
    dst = torch.empty_like(src)
    odd = torch.zeros(src.numel() + 1, device=cuda_device)[1:].view(src.shape).copy_(src)
    with pytest.raises(ValueError, match="aligned"):
        fk.ext_temporal_launcher(odd, dst, halo, None, cfg, 3)
    deepest = fk.temporal_info(torch.float32, device=cuda_device, ext=True)["max_steps"]
    deep_src, deep_halo, _ = _pass_shard(f, None, 2, 0, deepest + 1)
    with pytest.raises(ValueError, match="leaves no output tile"):
        fk.ext_temporal_launcher(deep_src, torch.empty_like(deep_src), deep_halo, None, cfg,
                                 deepest + 1)
    lib = fk.cuda_build.load_library()
    params = (ctypes.c_float * 9)(*fk.kernel_constants(cfg))
    rc = lib.lbm_temporal_steps_ext_launch(
        src.data_ptr(), dst.data_ptr(), halo[0].data_ptr(), halo[1].data_ptr(), None, None, None,
        None, 12, 40, 3, 0, 12, 0, 24, 0, 0, 0, 4, ctypes.addressof(params), 0,
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0  # 4 steps on 3-row halos
    largest = fk.temporal_info(torch.float32, device=cuda_device, ext=True)["rows"]
    with pytest.raises(ValueError, match="tile_rows"):
        fk.ext_temporal_launcher(src, dst, halo, None, cfg, 3, tile_rows=largest + 1)
    with pytest.raises(ValueError, match="tile_rows"):
        fk.ext_temporal_launcher(src, dst, halo, None, cfg, 3, tile_rows=6)
    end = fk.rdma_end(cfg, cuda_device, depth=3)
    grid = fk.rdma_temporal_grid(torch.float32, "none", 12, 40, 3, 1, cuda_device)
    assert grid["ctas"] >= fk.RDMA_SENDERS
    info = fk.temporal_info(torch.float32, "none", cuda_device, rdma=True)
    too_many = info["ctas_per_sm"] * torch.cuda.get_device_properties(cuda_device).multi_processor_count
    call = fk.rdma_temporal_launcher(src, dst, end, end, end, None, cfg, 3, card_shards=too_many)
    with pytest.raises(RuntimeError, match="cudaError"):
        call(1)


@pytest.mark.cuda
def test_rdma_temporal_withheld_send_raises_and_does_not_hang(cuda_device):
    """One shard of a ring of two launched alone in passes of 3: its edge
    tiles wait for rows that never come, give up after the timeout and
    leave the pass in the shard's error word; later passes of that shard
    skip their waits. Through the session the same ends in a raised
    RuntimeError, and a load clears it."""
    import time

    cfg, walls = _scene("column0")
    ring = _RdmaPassRing(cfg, None, 2, 3, cuda_device, timeout_s=0.2)
    t0 = time.perf_counter()
    assert ring.advance(3, only={0}) == [1, 0]
    assert 0.2 <= time.perf_counter() - t0 < 3.0
    t0 = time.perf_counter()
    for _ in range(10):
        assert ring.advance(3, only={0}) == [1, 0]
    assert time.perf_counter() - t0 < 0.2

    sess = sharded.ShardedRdmaSession(cfg, walls, mesh=sharded.make_mesh(devices=[cuda_device] * 2),
                                      timeout_s=0.2)
    assert sess.temporal == 3
    sess.load(_perturbed(cfg, cuda_device))
    (_, calls), = sess._plans[sess._parity]
    calls[0](1)  # shard 0 only
    with pytest.raises(RuntimeError, match="pass 1 waited"):
        sess.block()
    sess.load(_perturbed(cfg, cuda_device))  # a load clears the error
    sess.advance(7)
    sess.block()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_shard_temporal_kernels_walk_many_tiles_a_cta(dtype, cuda_device):
    """Both shard forms on rings of 1 and 4 virtual shards of 256x2048 (the
    reference barrier's wall spec), a pass of every L 1..T (T =
    SHARDED_TEMPORAL) at the launch's planned tile and at a forced tile of
    2 L + 1 rows, where every CTA walks many tiles, each loading while the
    previous one's levels run: bitwise against the local chain, the rdma
    form's comm blocks and flags against temporal_reference_rdma, and the
    plans' CTAs and tiles as the launchers report them."""
    cfg = LatticeConfig(nx=256, ny=2048, dtype=dtype)
    spec = geometry.infer_spec(geometry.reference_barrier(256, 2048))
    storage = fk._storage(cfg)
    T = sharded.SHARDED_TEMPORAL[storage]
    f = _perturbed(cfg, cuda_device, seed=5)
    for n in (1, 4):
        Ls = 256 // n
        for L in range(1, T + 1):
            want = fk.temporal_reference(f, spec, cfg, L)
            for tile_rows in (None, 2 * L + 1):
                for k in range(n):
                    src, halo, _ = _pass_shard(f, None, n, k, T)
                    dst = torch.full_like(src, float("nan"))
                    go = fk.ext_temporal_launcher(src, dst, halo, spec, cfg, L,
                                                  row_offset=k * Ls, tile_rows=tile_rows)
                    go()
                    torch.cuda.synchronize()
                    assert go.plan["ctas"] * go.plan["waves"] >= go.plan["tiles"]
                    assert torch.equal(dst, want[:, k * Ls:(k + 1) * Ls]), (n, L, tile_rows, k)
                ring = _RdmaPassRing(cfg, spec, n, T, cuda_device, tile_rows=tile_rows)
                ring.shards = [_pass_shard(f, None, n, k, T) for k in range(n)]
                ring.bufs[0] = [s_[0] for s_ in ring.shards]
                srcs = [b.clone() for b in ring.bufs[0]]
                ref_ends = [fk.rdma_end(cfg, cuda_device, depth=T) for _ in range(n)]
                assert ring.advance(L) == [0] * n
                refs = fk.temporal_reference_rdma(srcs, ref_ends, [spec] * n, cfg, L, 1)
                assert torch.equal(torch.cat(ring.bufs[1], 1), want), (n, L, tile_rows)
                plan = ring.launch(0, L).plan
                assert plan["rows"] == tile_rows or tile_rows is None
                assert plan["ctas"] * plan["waves"] >= plan["interior_tiles"] + plan["edge_tiles"]
                for k in range(n):
                    assert torch.equal(ring.bufs[1][k], refs[k])
                    for got, ref in zip(ring.ends[k][:3], ref_ends[k][:3]):
                        assert torch.equal(got, ref), (n, L, tile_rows, k)
                    assert not ring.ends[k].work.any()


@pytest.mark.cuda
def test_shard_forms_plan_as_their_plain_twin(cuda_device):
    """The shard forms' card (one CTA of 512 threads an SM, two tile
    buffers) and the plans their launchers make, at 800x4000's shards and
    at small ones, equal fused_kernel.shard_tile_plan (the plain twin) at
    the card's tile and slots, for both storages and 1 or 4 launches of the
    ring on the card; the local form keeps 2 CTAs of 256 threads."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for dtype, T in ((torch.float32, 3), (torch.bfloat16, 2)):
        local = fk.temporal_info(dtype, "spec", cuda_device)
        assert (local["threads"], local["buffers"]) == (256, 1)
        for kind in ("none", "plane", "spec"):
            for rdma in (False, True):
                info = fk.temporal_info(dtype, kind, cuda_device, ext=not rdma, rdma=rdma)
                assert (info["threads"], info["buffers"], info["ctas_per_sm"]) == (512, 2, 1)
                assert info["rows"] == local["rows"] and info["local_bytes"] == 0
        info = fk.temporal_info(dtype, "spec", cuda_device, ext=True)
        slots = info["ctas_per_sm"] * sms
        for rows, ny, L in ((200, 4000, T), (800, 4000, T), (12, 40, 1), (37, 136, 2)):
            twin = fk.shard_tile_plan(dtype, rows, ny, L, info["rows"], slots)
            card = fk.ext_temporal_plan(dtype, "spec", rows, ny, L, cuda_device)
            assert card == {key: twin[key] for key in card}, (dtype, rows, L)
            assert fk.temporal_info(dtype, "spec", cuda_device, ext=True,
                                    launch=(rows, ny, L))["plan"] == card
            for shards in (1, 4):
                twin = fk.shard_tile_plan(dtype, rows, ny, L, info["rows"], slots, rdma=True,
                                          card_shards=shards)
                card = fk.rdma_temporal_grid(dtype, "spec", rows, ny, L, shards, cuda_device)
                assert card == {key: twin[key] for key in card}, (dtype, rows, L, shards)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_sharded_backends_count_their_passes_by_form(dtype, cuda_device, monkeypatch):
    """sharded-cuda, sharded-cuda-fused and sharded-cuda-rdma over 4
    virtual shards of 48x40 (12-row shards), 20 steps in passes of T =
    SHARDED_TEMPORAL: the interior and two T-row bands of each shard and
    pass, one launch per shard and pass, or one rdma launch per shard and
    pass, counted per form with every step; no one-step launch; 2 halo
    blocks copied per shard and pass (none for rdma); bitwise equal to the
    cuda backend and to the same backend at temporal=1."""
    from latticeboltzmann_tpu_torch.models import engine

    cfg = LatticeConfig(nx=48, ny=40, dtype=dtype, accel=0.005)
    walls = geometry.channel(48, 40)
    walls[20:26, 0:3] = True
    T = sharded.SHARDED_TEMPORAL[fk._storage(cfg)]
    n_passes = -(-20 // T)
    want = Simulation(cfg, walls, backend="cuda").run(20).state()
    mesh = sharded.make_mesh(devices=[cuda_device] * 4)
    for backend, options, per_pass in (("sharded-cuda", {}, 12), ("sharded-cuda-fused",
                                       {"overlap": False}, 4), ("sharded-cuda-rdma",
                                                                {"rdma": True}, 4)):
        rdma = backend.endswith("rdma")
        outs = []
        for temporal in (None, 1):
            monkeypatch.setitem(engine._BACKENDS, backend, sharded.make_cuda_backend(
                mesh, temporal=temporal, **options))
            counters = (fk.EXT_LAUNCHES, fk.RDMA_LAUNCHES, fk.EXT_TEMPORAL_LAUNCHES,
                        fk.RDMA_TEMPORAL_LAUNCHES, fk.EXT_TEMPORAL_STEPS, fk.RDMA_TEMPORAL_STEPS)
            copies = sharded.HALO_COPIES
            sim = Simulation(cfg, walls, backend=backend, allow_experimental=True)
            outs.append(sim.run(20).state())
            got = [after - b for after, b in zip(
                (fk.EXT_LAUNCHES, fk.RDMA_LAUNCHES, fk.EXT_TEMPORAL_LAUNCHES,
                 fk.RDMA_TEMPORAL_LAUNCHES, fk.EXT_TEMPORAL_STEPS, fk.RDMA_TEMPORAL_STEPS),
                counters)]
            if temporal is None:
                steps = 20 * per_pass
                assert sim._session.temporal == T
                assert got == ([0, 0, 0, per_pass * n_passes, 0, steps] if rdma else
                               [0, 0, per_pass * n_passes, 0, steps, 0])
                assert sharded.HALO_COPIES - copies == (0 if rdma else 8 * n_passes)
            else:
                assert got[2:] == [0, 0, 0, 0] and got[1 if rdma else 0] > 0
        np.testing.assert_array_equal(outs[0], want)
        np.testing.assert_array_equal(outs[0], outs[1])


def _rand(shape, device, dtype=torch.float32, seed=0):
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(np.float32)
    return torch.as_tensor(x, device=device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ny", [40, 37, 4000])
def test_copy_kernel_equals_its_source(ny, dtype, cuda_device):
    """Both forms, bitwise; NY = 37 leaves the direct form a bytewise tail
    and the staged form only the tiles that are whole 16-byte vectors."""
    src = _rand((9, 24, ny), cuda_device, dtype)
    before = probes.LAUNCHES["copy-direct"], probes.LAUNCHES["copy-staged"]
    for kw in ({}, {"ctas_per_sm": 1}):  # a covering grid, a persistent one
        dst = torch.zeros_like(src)
        probes.copy_state(src, dst, **kw)
        torch.cuda.synchronize()
        assert torch.equal(dst, probes.copy_reference(src))
    staged = 0
    for rows, stages in ((8, 2), (4, 3), (1, 4), (24, 2)):
        dst = torch.zeros_like(src)
        try:
            probes.copy_state(src, dst, rows=rows, stages=stages)
        except ValueError:
            assert (rows * ny * src.element_size()) % 16 or \
                stages * rows * ny * src.element_size() > probes.MAX_SHARED_BYTES
            continue
        torch.cuda.synchronize()
        assert torch.equal(dst, src)
        staged += 1
    assert staged >= 1
    assert probes.LAUNCHES["copy-direct"] == before[0] + 2
    assert probes.LAUNCHES["copy-staged"] == before[1] + staged
    # a misaligned view takes the direct form's bytewise path
    flat = _rand((src.numel() + 1,), cuda_device, dtype)
    view = flat[1:].view_as(src)
    dst = torch.zeros_like(flat)[1:].view_as(src)
    probes.copy_state(view, dst)
    torch.cuda.synchronize()
    assert torch.equal(dst, view)


@pytest.mark.cuda
@pytest.mark.parametrize("mechanism", ["shared", "shuffle"])
@pytest.mark.parametrize("ny", [40, 37, 4000])
def test_roll_y_kernel_equals_chained_rolls(ny, mechanism, cuda_device):
    x = _rand((32, ny), cuda_device)
    before = probes.LAUNCHES[f"roll_y-{mechanism}"]
    launched = 0
    for shift in (1, ny - 1, 96, ny, 31, -31):
        for n in (0, 1, 6):
            try:
                got = probes.roll_y(x, shift, n, mechanism=mechanism)
            except ValueError:
                assert mechanism == "shuffle"
                continue
            launched += 1
            torch.cuda.synchronize()
            assert torch.equal(got, probes.roll_y_reference(x, shift, n))
    assert launched and probes.LAUNCHES[f"roll_y-{mechanism}"] == before + launched


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("ny", [37, 4000])
def test_align_kernel_equals_chained_adds(ny, axis, cuda_device):
    x = _rand((40, ny), cuda_device)
    before = probes.LAUNCHES[f"align-axis{axis}"]
    for offset in (0, 1, 2):
        for n in (0, 8):
            got = probes.align(x, offset, n, axis=axis)
            torch.cuda.synchronize()
            assert torch.equal(got, probes.align_reference(x, offset, n, axis))
    assert probes.LAUNCHES[f"align-axis{axis}"] == before + 6


@pytest.mark.cuda
@pytest.mark.parametrize("mechanism", ["shared", "global"])
@pytest.mark.parametrize("ny", [37, 4000])
def test_roll_x_kernel_equals_chained_rolls(ny, mechanism, cuda_device):
    x = _rand((40, ny), cuda_device)
    before = probes.LAUNCHES[f"roll_x-{mechanism}"]
    for shift in (1, 39):
        for n in (0, 1, 8, 9):
            got = probes.roll_x(x, shift, n, mechanism=mechanism)
            torch.cuda.synchronize()
            assert torch.equal(got, probes.roll_x_reference(x, shift, n))
    assert probes.LAUNCHES[f"roll_x-{mechanism}"] == before + 8


def _roll_shifts(n):
    """Every residue mod 4, and the wrap: chip_smoke.py's phase 18."""
    return (1, 2, 3, 4, 5, 96, n - 1, n - 2, n)


def _form_counts():
    return {k: n for k, n in probes.ROLL_FORM_LAUNCHES.items() if n}


@pytest.mark.cuda
@pytest.mark.parametrize("ny", [4000, 40, 37])
def test_roll_y_forms_equal_chained_rolls_and_one_roll(ny, cuda_device):
    """Both forms of the shared-memory y-roll bitwise against roll_y_reference
    and one torch.roll by the summed shift; the wide form runs wherever NY
    is a multiple of 16 (4000), the narrow one everywhere, and form="wide"
    raises at 40 and 37; form=None is the narrow form; launches counted
    by form."""
    x = _rand((32, ny), cuda_device, seed=1)
    forms = ("wide", "narrow") if ny % 16 == 0 else ("narrow",)
    before = collections.Counter(_form_counts())
    for shift in _roll_shifts(ny):
        for n in (0, 1, 6, 7):
            for form in forms:
                got = probes.roll_y(x, shift, n, form=form)
                torch.cuda.synchronize()
                assert torch.equal(got, probes.roll_y_reference(x, shift, n)), (shift, n, form)
                assert torch.equal(got, torch.roll(x, n * shift % ny, 1))
    if ny % 16:
        with pytest.raises(ValueError):
            probes.roll_y(x, 1, 6, form="wide")
    assert torch.equal(probes.roll_y(x, 3, 6), torch.roll(x, 18 % ny, 1))
    want = before + collections.Counter({f"roll_y-{f}": 36 for f in forms})
    want["roll_y-narrow"] += 1
    assert _form_counts() == dict(want)


@pytest.mark.cuda
def test_roll_y_wide_form_fits_the_card(cuda_device):
    """The wide y-roll's cluster launch at (32, 4000) fits the card
    (cudaOccupancyMaxActiveClusters), and the form takes the shift's four
    residues through one launch each of 9 rolls, bitwise."""
    x = _rand((32, 4000), cuda_device, seed=2)
    assert probes.roll_y_clusters(32, 4000) >= 1
    for shift in (1, 2, 3, 4, 1001, 3999):
        got = probes.roll_y(x, shift, 9, form="wide")
        torch.cuda.synchronize()
        assert torch.equal(got, probes.roll_y_reference(x, shift, 9)), shift


@pytest.mark.cuda
@pytest.mark.parametrize("ny", [4000, 40, 37])
def test_roll_x_forms_equal_chained_rolls_and_one_roll(ny, cuda_device):
    """Both forms of the shared-memory x-roll bitwise against
    roll_x_reference and one torch.roll; the wide form (the default) where
    NY is a multiple of 4; launches counted by form."""
    x = _rand((40, ny), cuda_device, seed=3)
    before = collections.Counter(_form_counts())
    launched = collections.Counter()
    forms = [None, "narrow", "wide"] if ny % 4 == 0 else [None, "narrow"]
    for shift in (*_roll_shifts(ny), 39):
        for n in (0, 1, 6, 7, 8, 9):
            for form in forms:
                got = probes.roll_x(x, shift, n, form=form)
                torch.cuda.synchronize()
                assert torch.equal(got, probes.roll_x_reference(x, shift, n)), (shift, n, form)
                assert torch.equal(got, torch.roll(x, n * shift % 40, 0))
                launched[f"roll_x-{form or ('wide' if ny % 4 == 0 else 'narrow')}"] += 1
    if ny % 4:
        with pytest.raises(ValueError):
            probes.roll_x(x, 1, 8, form="wide")
    assert _form_counts() == dict(before + launched)


@pytest.mark.cuda
def test_roll_forms_follow_the_pointers_on_the_card(cuda_device):
    """A block that is not 16-byte aligned takes the narrow forms; form="wide"
    refuses it and launches nothing."""
    flat = _rand((32 * 4000 + 1,), cuda_device, seed=4)
    x = flat[1:].view(32, 4000)
    before = _form_counts()
    assert torch.equal(probes.roll_y(x, 3, 6), torch.roll(x, 18, 1))
    assert torch.equal(probes.roll_x(x, 3, 6), torch.roll(x, 18, 0))
    for roll in (probes.roll_y, probes.roll_x):
        with pytest.raises(ValueError):
            roll(x, 1, 6, form="wide")
    want = collections.Counter(before) + collections.Counter({"roll_y-narrow": 1,
                                                              "roll_x-narrow": 1})
    assert _form_counts() == dict(want)


# the flat kernel's temporal depths held against its plain versions: a
# sweep and each storage type's default
FLAT_TEMPORALS = tuple(sorted({1, 2, 3, 4, 8, *fk.FLAT_TEMPORAL.values()}))


def _flat_scene(name, dtype):
    """column0, empty: the step scenes, wall-free; small: a lattice
    smaller than one tile; ragged: tiles ragged in both axes and an NY no
    16-byte vector divides (the element-by-element loads and stores)."""
    if name == "small":
        return LatticeConfig(nx=5, ny=3, dtype=dtype, accel=0.005)
    if name == "ragged":
        return LatticeConfig(nx=37, ny=1001, dtype=dtype)
    return _scene(name, dtype)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("name", ["column0", "empty", "small", "ragged"])
def test_flat_kernel_equals_flat_reference(name, dtype, cuda_device):
    """2, 8, 16 and 10 steps in one cooperative launch at every temporal
    depth of FLAT_TEMPORALS, the whole stacked pair bitwise against
    flat_reference and against flat_reference_blocked at the kernel's own
    tile; the forcing guard fails at one column-0 site."""
    cfg = _flat_scene(name, dtype)
    f = _perturbed(cfg, cuda_device)
    f[6, cfg.nx // 2, 0] = 1e-6
    before = fk.FLAT_LAUNCHES
    counts = (2, 16) if name == "ragged" else (2, 8, 16, 10)
    for n in counts:
        f2 = torch.stack([f, torch.full_like(f, float("nan"))])
        want = fk.flat_reference(f2, cfg, n)
        for temporal in FLAT_TEMPORALS:
            f2 = torch.stack([f, torch.full_like(f, float("nan"))])
            got = fk.make_flat_step(cfg, n, temporal=temporal)(f2)
            blocked = fk.flat_reference_blocked(torch.stack([f, f]), cfg, n, temporal,
                                                fk.flat_tile(f.dtype))
            torch.cuda.synchronize()
            assert got is f2 and torch.equal(got, want), (n, temporal)
            assert torch.equal(blocked, want), (n, temporal)
    assert fk.FLAT_LAUNCHES == before + len(counts) * len(FLAT_TEMPORALS)
    # the one-launch-per-step kernel gives the same state
    assert torch.equal(want[0], fk.run_steps(f, geometry.empty(cfg.nx, cfg.ny), cfg, counts[-1],
                                             temporal=1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_flat_kernel_tile_and_grids_equal_flat_reference(dtype, cuda_device):
    """The tile the card gives: two CTAs per SM by the card's own
    occupancy count, an output left at the default depth. Depths 1 and 4,
    16 steps at 100x200 (ragged row tiles), and the default depth on the
    full grid and on a grid of 3 CTAs that walk many tiles each:
    bitwise."""
    cfg = LatticeConfig(nx=100, ny=200, dtype=dtype, accel=0.005)
    f = _perturbed(cfg, cuda_device)
    info = fk.flat_info(f.dtype)
    assert info["ctas_per_sm"] == 2
    tile = fk.flat_tile(f.dtype)
    assert min(fk.flat_output(tile, f.dtype, fk.FLAT_TEMPORAL[f.dtype])) >= 1
    want = fk.flat_reference(torch.stack([f, f]), cfg, 16)
    for temporal in (1, 4, None):
        got = fk.flat_step(torch.stack([f, f]), cfg, 16, temporal=temporal)
        torch.cuda.synchronize()
        assert torch.equal(got, want), temporal
    got = fk.flat_step(torch.stack([f, f]), cfg, 16, blocks=3)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_flat_step_refuses_a_depth_its_tile_cannot_take(cuda_device):
    """A temporal whose pass leaves no output row in the card's float32
    tile raises ValueError before any launch and leaves the state."""
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    f = _perturbed(cfg, cuda_device)
    f2 = torch.stack([f, f])
    deep = (fk.flat_tile(torch.float32).rows + 1) // 2
    assert deep <= fk.FLAT_MAX_TEMPORAL
    before = fk.FLAT_LAUNCHES
    with pytest.raises(ValueError, match="leaves no output"):
        fk.flat_step(f2, cfg, 4, temporal=deep)
    assert fk.FLAT_LAUNCHES == before and torch.equal(f2[0], f)


@pytest.mark.cuda
def test_flat_kernel_fast_math_within_its_tolerance(cuda_device):
    cfg = LatticeConfig(nx=48, ny=96, dtype=np.float32)
    f = _perturbed(cfg, cuda_device)
    f2 = torch.stack([f, f])
    want = fk.flat_reference(f2, cfg, fk.FAST_MATH_STEPS)[0]
    got = fk.make_flat_step(cfg, fk.FAST_MATH_STEPS, fast_math=True)(f2)[0]
    assert float(((got - want).abs() / want.abs()).max()) <= fk.FAST_MATH_RTOL


@pytest.mark.cuda
def test_failed_cooperative_launch_raises(cuda_device):
    """A grid the card cannot hold at once is refused by the cooperative
    launch: the wrapper raises, counts nothing, leaves the state as it was,
    and the next launch works."""
    cfg, _ = _scene("empty")
    f = _perturbed(cfg, cuda_device)
    f2 = torch.stack([f, f])
    before = fk.FLAT_LAUNCHES
    with pytest.raises(RuntimeError, match="cooperative launch failed"):
        fk.flat_step(f2, cfg, 2, blocks=10**6)
    torch.cuda.synchronize()
    assert fk.FLAT_LAUNCHES == before and torch.equal(f2[0], f)
    fk.flat_step(f2, cfg, 2)
    torch.cuda.synchronize()
    assert torch.equal(f2, fk.flat_reference(torch.stack([f, f]), cfg, 2))


# --- the temporal form: passes of L steps with walls -------------------------

def _temporal_geoms(cfg, device):
    """Every geometry source of the temporal form on a channel whose walls
    reach column 0: {kind: geom} (plane and slip planes on the card)."""
    nx, ny = cfg.nx, cfg.ny
    walls = geometry.channel(nx, ny)
    walls[nx // 3: nx // 3 + 3, 0:3] = True
    open_top = walls.copy()
    open_top[0] = False
    slip_x = np.zeros_like(walls)
    slip_x[0] = True
    slip_y = np.zeros_like(walls)
    slip_y[nx // 2, 5:7] = True
    return {"none": None, "plane": torch.as_tensor(walls.astype(np.uint8), device=device),
            "spec": (("channel",), ("rect", nx // 3, nx // 3 + 3, 0, 3)),
            "slip": torch.as_tensor(fk.class_plane(open_top, slip_x, slip_y), device=device)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 40), (5, 8), (100, 96)])
def test_temporal_kernel_equals_its_plain_versions(shape, dtype, cuda_device):
    """One pass of L steps for every L the card's tile takes (at 100x96,
    several of them), every geometry source, bitwise against
    temporal_reference (L chained step_reference) and
    temporal_reference_blocked at the card's tile; 5x8 is smaller than
    one tile, 100x96 ragged in both axes. Every launch counted, with its
    steps and variant."""
    cfg = LatticeConfig(nx=shape[0], ny=shape[1], dtype=dtype, accel=0.005)
    f = _perturbed(cfg, cuda_device)
    f[6, cfg.nx // 2, 0] = 1e-6  # the guard fails at one column-0 site
    info = fk.temporal_info(f.dtype)
    tile, most = fk.FlatTile(info["rows"], info["width"]), info["max_steps"]
    assert most == fk.tile_max_steps(tile, f.dtype) >= 8
    depths = range(1, most + 1) if cfg.sites < 1000 else (1, 2, 3, 5, 8, most)
    before = (fk.TEMPORAL_LAUNCHES, fk.TEMPORAL_STEPS, fk.LAUNCHES)
    variants = collections.Counter()
    for kind, geom in _temporal_geoms(cfg, cuda_device).items():
        for steps in depths:
            want = fk.temporal_reference(f, geom, cfg, steps)
            got = fk.temporal_step(f, torch.full_like(f, float("nan")), geom, cfg, steps)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (kind, steps)
            if steps <= 3 or steps == most:
                blocked = fk.temporal_reference_blocked(f, geom, cfg, steps, tile)
                assert torch.equal(blocked, want), (kind, steps)
            variants[fk.variant_name(f.dtype, "plane" if kind == "slip" else kind,
                                     kind == "slip", False)] += 1
    assert (fk.TEMPORAL_LAUNCHES, fk.TEMPORAL_STEPS, fk.LAUNCHES) == (
        before[0] + 4 * len(depths), before[1] + 4 * sum(depths), before[2])
    for name, n in variants.items():
        assert fk.TEMPORAL_VARIANT_LAUNCHES[name] >= n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_temporal_session_equals_one_step_per_launch(dtype, cuda_device):
    """Simulation(backend="cuda", temporal=T) on a 48x96 plate (the spec
    variant) and a slip scene (the plane variant): run(7) + run(13) at
    T=3, passes of 3, 3, 1 and 3, 3, 3, 3, 1 steps and no one-step
    launch, bitwise equal to 20 steps at temporal=1; run(20) at T=3
    too."""
    cfg = LatticeConfig(nx=48, ny=96, dtype=dtype)
    walls, slip_x, slip_y = _slip_scene(48, 96)
    for walls_, kw in ((_plate_48x96(), {}), (walls, {"slip_x": slip_x, "slip_y": slip_y})):
        want = Simulation(cfg, walls_, backend="cuda", temporal=1, **kw).run(20).state()
        sim = Simulation(cfg, walls_, backend="cuda", temporal=3, **kw)
        before = (fk.LAUNCHES, fk.TEMPORAL_LAUNCHES, fk.TEMPORAL_STEPS)
        np.testing.assert_array_equal(sim.run(7).run(13).state(), want)
        assert (fk.LAUNCHES, fk.TEMPORAL_LAUNCHES, fk.TEMPORAL_STEPS) == (
            before[0], before[1] + 3 + 5, before[2] + 20)
        again = Simulation(cfg, walls_, backend="cuda", temporal=3, **kw).run(20).state()
        np.testing.assert_array_equal(again, want)


@pytest.mark.cuda
def test_temporal_form_refuses_on_the_card(cuda_device):
    """A pass deeper than the card's tile takes, a buffer that is no
    16-byte aligned allocation, a row of no whole vectors: ValueError
    before any launch; Simulation(temporal=) past the tile too."""
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    f = _perturbed(cfg, cuda_device)
    out = torch.empty_like(f)
    most = fk.temporal_info(torch.float32)["max_steps"]
    before = fk.TEMPORAL_LAUNCHES
    with pytest.raises(ValueError, match="at most"):
        fk.temporal_step(f, out, None, cfg, most + 1)
    flat = torch.zeros(f.numel() + 1, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        fk.temporal_step(f, flat[1:].view_as(f), None, cfg, 2)
    cfg37 = LatticeConfig(nx=16, ny=37, dtype=np.float32)
    f37 = _perturbed(cfg37, cuda_device)
    with pytest.raises(ValueError, match="multiple of"):
        fk.temporal_step(f37, torch.empty_like(f37), None, cfg37, 2)
    assert fk.TEMPORAL_LAUNCHES == before
    with pytest.raises(ValueError, match="at most"):
        Simulation(cfg, geometry.channel(16, 40), backend="cuda", temporal=most + 1)
    with pytest.raises(ValueError, match="at most"):
        Simulation(cfg37, geometry.channel(16, 37), backend="cuda", temporal=most + 1)
    # at NY 37 the facade's session chooses one step per launch by shape
    sim = Simulation(cfg37, geometry.channel(16, 37), backend="cuda", temporal=2)
    assert (sim._session.temporal, sim._session.requested_temporal) == (1, 2)
    assert fk.TEMPORAL_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_temporal_at_an_ny_of_no_whole_vectors_runs_the_narrow_form(dtype, cuda_device):
    """Simulation(backend="cuda", temporal=6) at 48x98 (no whole 16-byte
    vectors a row in f32 or bf16): one narrow-form launch of the one-step
    kernel per step, no pass of the temporal form, bitwise equal to
    temporal=None."""
    cfg = LatticeConfig(nx=48, ny=98, dtype=dtype)
    walls = geometry.channel(48, 98)
    walls[10:30, 20:25] = True
    f0 = _perturbed(cfg, cuda_device).float().cpu().numpy()
    want = Simulation(cfg, walls, backend="cuda", f0=f0).run(25).state()
    narrow, passes, launches = fk.FORM_LAUNCHES["narrow"], fk.TEMPORAL_LAUNCHES, fk.LAUNCHES
    sim = Simulation(cfg, walls, backend="cuda", f0=f0, temporal=6)
    assert (sim._session.temporal, sim._session.requested_temporal) == (1, 6)
    got = sim.run(13).run(12).state()
    assert fk.FORM_LAUNCHES["narrow"] == narrow + 25 and fk.LAUNCHES == launches + 25
    assert fk.TEMPORAL_LAUNCHES == passes
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_default_depth_follows_the_rows_on_the_card(dtype, cuda_device):
    """Simulation(backend="cuda") with no depth: at 48x96 (whole 16-byte
    vectors a row) passes of fused_kernel.DEFAULT_TEMPORAL through the
    temporal form, a rest of one step (13 = 6 + 6 + 1) one launch of the
    one-step kernel; at 48x98 one narrow launch of the one-step kernel per
    step, no pass; each bitwise equal to temporal=1."""
    for ny in (96, 98):
        cfg = LatticeConfig(nx=48, ny=ny, dtype=dtype)
        depth = fk.DEFAULT_TEMPORAL[fk._storage(cfg)] if ny == 96 else 1
        walls = geometry.channel(48, ny)
        walls[10:30, 20:25] = True
        f0 = _perturbed(cfg, cuda_device).float().cpu().numpy()
        want = Simulation(cfg, walls, backend="cuda", f0=f0, temporal=1).run(25).state()
        counts = (fk.LAUNCHES, fk.FORM_LAUNCHES["narrow"], fk.TEMPORAL_LAUNCHES,
                  fk.TEMPORAL_STEPS)
        sim = Simulation(cfg, walls, backend="cuda", f0=f0)
        assert sim.temporal is None
        assert (sim._session.temporal, sim._session.requested_temporal) == (depth, None)
        got = sim.run(13).run(12).state()
        plans = [divmod(n, depth) for n in (13, 12)]
        passes = sum(full + (rest > 1) for full, rest in plans)
        ones = sum(rest == 1 for _, rest in plans)
        assert (fk.LAUNCHES, fk.FORM_LAUNCHES["narrow"], fk.TEMPORAL_LAUNCHES,
                fk.TEMPORAL_STEPS) == ((counts[0] + ones, counts[1], counts[2] + passes,
                                        counts[3] + 25 - ones)
                                       if depth > 1 else
                                       (counts[0] + 25, counts[1] + 25, counts[2], counts[3]))
        assert sim.counters() == {"launches": passes + ones if depth > 1 else 25, "steps": 25,
                                  "samples": 0}
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("nx, ny, dtype", [(800, 4000, np.float32), (4000, 16000, "bfloat16")])
def test_default_depth_at_the_benchmark_configurations(nx, ny, dtype, cuda_device):
    """The benchmark cells' two configurations (the upstream's channel
    edges and 200x5 plate): Simulation(backend="cuda") runs
    DEFAULT_TEMPORAL, a 1,000-step run in 1000 // T passes of T and one of
    the rest, no one-step launch; from one perturbed state, run(1000) and then run_probed(1000, 3
    probes, every=100) bitwise equal to temporal=1's states and series."""
    cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype)
    walls = geometry.reference_barrier(nx, ny)
    sim = Simulation(cfg, walls, backend="cuda")
    depth = fk.DEFAULT_TEMPORAL[fk._storage(cfg)]
    assert (sim._session.temporal, sim._session.requested_temporal) == (depth, None)
    one = Simulation(cfg, walls, backend="cuda", temporal=1)
    gen = torch.Generator(device=cuda_device).manual_seed(26)
    f = one.f.float()
    f *= 1 + 0.05 * (2 * torch.rand(f.shape, generator=gen, device=cuda_device) - 1)
    sim.f = one.f = f
    del f
    before = fk.LAUNCHES
    sim.run(1000)
    assert fk.LAUNCHES == before
    assert sim.counters()["launches"] == -(-1000 // depth)
    one.run(1000)
    assert torch.equal(sim.f, one.f)
    probes = [(50, 150), (120, 300), (200, 550)]
    series = sim.run_probed(1000, probes, every=100)
    np.testing.assert_array_equal(series, one.run_probed(1000, probes, every=100))
    assert sim.counters()["launches"] == -(-1000 // depth) + 10 * -(-100 // depth)
    assert torch.equal(sim.f, one.f)


@pytest.mark.cuda
def test_temporal_kernel_fast_math_within_its_tolerance(cuda_device):
    cfg = LatticeConfig(nx=48, ny=96, dtype=np.float32)
    f = _perturbed(cfg, cuda_device)
    spec = geometry.infer_spec(_plate_48x96())
    want = fk.temporal_reference(f, spec, cfg, fk.FAST_MATH_STEPS)
    got = fk.temporal_step(f, torch.empty_like(f), spec, cfg, fk.FAST_MATH_STEPS,
                           fast_math=True)
    assert float(((got - want).abs() / want.abs()).max()) <= fk.FAST_MATH_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_temporal_kernel_walks_many_tiles_a_cta(dtype, cuda_device):
    """The local form on 256x2048 (the reference barrier's wall spec, and
    a slip scene as the plane variant), one pass of every L the card's
    tile takes, where every CTA walks many tiles, each tile's bottom rows
    loading under its first level's top rows, and some tiles hold global
    column 0: bitwise against temporal_reference; every launch counted."""
    cfg = LatticeConfig(nx=256, ny=2048, dtype=dtype)
    spec = geometry.infer_spec(geometry.reference_barrier(256, 2048))
    walls, slip_x, slip_y = _slip_scene(256, 2048)
    slip = torch.as_tensor(fk.class_plane(walls, slip_x, slip_y), device=cuda_device)
    f = _perturbed(cfg, cuda_device, seed=7)
    most = fk.temporal_info(f.dtype)["max_steps"]
    before = fk.TEMPORAL_LAUNCHES
    for geom in (spec, slip):
        want = f
        for L in range(1, most + 1):
            want = fk.temporal_reference(want, geom, cfg, 1)
            got = fk.temporal_step(f, torch.full_like(f, float("nan")), geom, cfg, L)
            torch.cuda.synchronize()
            assert torch.equal(got, want), L
    assert fk.TEMPORAL_LAUNCHES == before + 2 * most


def _ds_ring_shard(a, solid, n, k, depth):
    """Shard k of a ring of n over the card's pair a: its pair, its (top,
    bot) halo pairs of `depth` rows from the ring neighbours (rows by
    modulo), its ShardPlane with (depth, NY) class rows; all whole
    allocations."""
    nx = a.hi.shape[1]
    L = nx // n

    def rows(x, lo, hi):
        return x[..., [r % nx for r in range(lo, hi)], :].contiguous()

    r0 = k * L
    pair = df64.DS(rows(a.hi, r0, r0 + L), rows(a.lo, r0, r0 + L))
    halo = tuple(df64.DS(rows(a.hi, p, q), rows(a.lo, p, q))
                 for p, q in ((r0 - depth, r0), (r0 + L, r0 + L + depth)))
    plane = fk.ShardPlane(rows(solid, r0, r0 + L), rows(solid, r0 - depth, r0),
                          rows(solid, r0 + L, r0 + L + depth))
    return pair, halo, plane


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("has_walls", [True, False])
def test_ds_ext_temporal_kernel_equals_its_plain_versions(has_walls, exact, cuda_device):
    """The ext-halo temporal form: one pass at every L from 1 to 4 with
    halos of Td = 4 and Td = L rows, on rings of 1, 2 and 4 shards of
    24x40, 2 shards of 5x8 and one shard of 37x64 (a ragged last tile),
    each over the whole shard, its two L-row edge bands and the interior
    between them; the deepest pass the tile takes at Td = that depth on
    the one-shard rings: bitwise against temporal_reference_ext, the whole
    shard also against temporal_reference_ext_blocked at the card's tile
    (L 1-2), and the rows outside the range untouched; every launch counted
    as the ext-halo temporal form's."""
    info = fdk.temporal_info(exact, has_walls, ext=True)
    tile = fk.FlatTile(info["rows"], info["width"])
    launches = 0
    for (nx, ny), rings in (((24, 40), (1, 2, 4)), ((10, 8), (2,)), ((37, 64), (1,))):
        cfg, a, solid = _ds_temporal_scene(nx, ny, cuda_device)
        for n in rings:
            for k in range(n):
                depths = [(L, Td) for L in range(1, 5) for Td in sorted({4, L})]
                if n == 1:
                    depths.append((info["max_steps"], info["max_steps"]))
                for L, Td in depths:
                    pair, halo, plane = _ds_ring_shard(a, solid, n, k, Td)
                    plane = plane if has_walls else None
                    Ls = pair.hi.shape[1]
                    want = fdk.temporal_reference_ext(pair.hi, pair.lo, halo, plane, cfg, exact, L)
                    ranges = [(0, Ls), (0, min(L, Ls)), (max(Ls - L, 0), min(L, Ls))]
                    ranges += [(L, Ls - 2 * L)] if Ls > 2 * L else []
                    for row0, rows in ranges:
                        dst = df64.DS(torch.full_like(pair.hi, float("nan")),
                                      torch.full_like(pair.lo, float("nan")))
                        fdk.ext_temporal_launcher(pair, dst, halo, plane, cfg, L,
                                                  has_walls=has_walls, exact=exact, row0=row0,
                                                  rows=rows)()
                        launches += 1
                        torch.cuda.synchronize()
                        got = df64.DS(dst.hi[:, row0:row0 + rows], dst.lo[:, row0:row0 + rows])
                        ref = df64.DS(want.hi[:, row0:row0 + rows], want.lo[:, row0:row0 + rows])
                        assert torch.equal(got.hi, ref.hi) and torch.equal(got.lo, ref.lo), (
                            nx, n, k, L, Td, row0, rows)
                        outside = torch.ones(Ls, dtype=torch.bool, device=cuda_device)
                        outside[row0:row0 + rows] = False
                        assert torch.isnan(dst.hi[:, outside]).all()
                    if L <= 2:
                        b = fdk.temporal_reference_ext_blocked(pair.hi, pair.lo, halo, plane,
                                                               cfg, exact, L, tile)
                        assert torch.equal(b.hi, want.hi) and torch.equal(b.lo, want.lo)
    assert launches > 0


@pytest.mark.cuda
def test_ds_ext_temporal_form_refuses_on_the_card(cuda_device):
    """A pass deeper than the halos (and, at the C entry point, the same
    launch with the Python checks passed by), a range that reads past the
    shard without halos, a halo block 4 bytes off a 16-byte boundary, NY no
    multiple of 4 and a pass deeper than the tile: refused, no launch."""
    from latticeboltzmann_tpu_torch.ops import cuda_build

    cfg, a, solid = _ds_temporal_scene(16, 40, cuda_device)
    pair, halo, plane = _ds_ring_shard(a, solid, 2, 0, 2)
    dst = df64.DS(torch.empty_like(pair.hi), torch.empty_like(pair.lo))
    before = (fdk.EXT_TEMPORAL_LAUNCHES, fdk.EXT_LAUNCHES)
    with pytest.raises(ValueError, match="halos hold 2"):
        fdk.ext_temporal_launcher(pair, dst, halo, plane, cfg, 3, has_walls=True)
    with pytest.raises(ValueError, match="give the halos"):
        fdk.ext_temporal_launcher(pair, dst, None, plane, cfg, 2, has_walls=True)
    n = halo[0].hi.numel()
    off = torch.empty(n + 1, dtype=torch.float32, device=cuda_device)[1:].view_as(halo[0].hi)
    with pytest.raises(ValueError, match="aligned"):
        fdk.ext_temporal_launcher(pair, dst, (df64.DS(off, halo[0].lo), halo[1]), plane, cfg, 2,
                                  has_walls=True)
    deepest = fdk.temporal_info(False, True, ext=True)["max_steps"]
    deep = _ds_ring_shard(a, solid, 1, 0, deepest + 1)
    whole = df64.DS(torch.empty_like(a.hi), torch.empty_like(a.lo))
    with pytest.raises(ValueError, match="no output tile"):
        fdk.ext_temporal_launcher(deep[0], whole, deep[1], deep[2], cfg, deepest + 1,
                                  has_walls=True)
    cfg38, a38, solid38 = _ds_temporal_scene(16, 38, cuda_device)
    p38, h38, pl38 = _ds_ring_shard(a38, solid38, 2, 0, 2)
    with pytest.raises(ValueError, match="multiple of 4"):
        fdk.ext_temporal_launcher(p38, df64.DS(torch.empty_like(p38.hi), torch.empty_like(p38.lo)),
                                  h38, pl38, cfg38, 2, has_walls=True)
    consts = fdk.kernel_constants_ds(cfg, False)
    params = (ctypes.c_float * len(consts))(*consts)
    top, bot = halo
    rc = cuda_build.load_library().lbm_ds_temporal_steps_ext_launch(
        pair.hi.data_ptr(), pair.lo.data_ptr(), dst.hi.data_ptr(), dst.lo.data_ptr(),
        top.hi.data_ptr(), top.lo.data_ptr(), bot.hi.data_ptr(), bot.lo.data_ptr(),
        plane.plane.data_ptr(), plane.top.data_ptr(), plane.bot.data_ptr(), 8, 40, 2, 0, 8, 1, 0,
        3, ctypes.addressof(params), torch.cuda.current_stream().cuda_stream)
    assert rc != 0
    assert (fdk.EXT_TEMPORAL_LAUNCHES, fdk.EXT_LAUNCHES) == before


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [True, False])
def test_sharded_cuda_ds64_counts_launches_per_form(cuda_device, monkeypatch, overlap):
    """sharded-cuda-ds64 over 4 virtual shards of 12 rows (48x40), 10
    steps: passes of 4, 4 and 2 of the ext-halo temporal form, each shard's
    interior and two bands (overlap) or one launch (a shard of fewer than
    2 s + 1 rows, or without overlap), no one-step launch, bitwise equal to
    cuda-ds64; on 8 shards of 3 rows, at the exact tier and at NY 38 every
    step is a one-step ext-halo launch (3 a shard and step with overlap),
    bitwise the same; the backend's default schedule is overlap=False."""
    from latticeboltzmann_tpu_torch.models import engine

    assert sharded.ShardedDSSession.__init__.__kwdefaults__["overlap"] is False
    mesh4 = sharded.make_mesh(devices=[cuda_device] * 4)
    monkeypatch.setitem(engine._BACKENDS, "sharded-cuda-ds64",
                        sharded.make_cuda_ds_backend(mesh4, overlap=overlap))
    cfg, a, solid = _ds_temporal_scene(48, 40, cuda_device)
    walls = solid.cpu().numpy() == 1
    f0 = df64.to_f64(a)
    before = (fdk.EXT_LAUNCHES, fdk.EXT_TEMPORAL_LAUNCHES, fdk.EXT_TEMPORAL_STEPS)
    out = Simulation(cfg, walls, backend="sharded-cuda-ds64", f0=f0).run(10).state()
    per_pass = {4: 3 if overlap else 1, 2: 3 if overlap else 1}
    want = (before[0], before[1] + 4 * (2 * per_pass[4] + per_pass[2]),
            before[2] + 4 * (2 * 4 * per_pass[4] + 2 * per_pass[2]))
    assert (fdk.EXT_LAUNCHES, fdk.EXT_TEMPORAL_LAUNCHES, fdk.EXT_TEMPORAL_STEPS) == want
    np.testing.assert_array_equal(
        out, Simulation(cfg, walls, backend="cuda-ds64", f0=f0).run(10).state())
    for label, mesh, kw, nyy in (("3-row shards", [cuda_device] * 16, {}, 40),
                                 ("exact tier", [cuda_device] * 4, {"exact": True}, 40),
                                 ("NY 38", [cuda_device] * 4, {}, 38)):
        c, p, s = _ds_temporal_scene(48, nyy, cuda_device)
        w = s.cpu().numpy() == 1
        sess = sharded.ShardedDSSession(c, w, mesh=sharded.make_mesh(devices=mesh),
                                        overlap=overlap, **kw)
        assert sess.temporal == 1, label
        sess.load(p)
        before = (fdk.EXT_LAUNCHES, fdk.EXT_TEMPORAL_LAUNCHES)
        sess.advance(5)
        per_step = len(mesh) * (3 if overlap else 1)
        assert (fdk.EXT_LAUNCHES, fdk.EXT_TEMPORAL_LAUNCHES) == (
            before[0] + 5 * per_step, before[1]), label
        got = sess.unload()
        ref = fdk.run_steps(p, w, c, 5, exact=kw.get("exact", False))
        assert torch.equal(got.hi, ref.hi) and torch.equal(got.lo, ref.lo), label


# --- the probed run (Simulation.run_probed) on the card ----------------------

PROBES = np.array([[5, 7], [12, 30], [1, 0], [15, 39]])


@pytest.mark.cuda
@pytest.mark.parametrize("every", [1, 8, 3])
@pytest.mark.parametrize("backend,dtype", [("cuda", np.float32), ("cuda", "bfloat16"),
                                           ("cuda-ds64", np.float64),
                                           ("sharded-cuda", np.float32),
                                           ("sharded-cuda-rdma", np.float32),
                                           ("sharded-cuda-ds64", np.float64)])
def test_run_probed_bitwise_run_and_probe_values(cuda_device, monkeypatch, backend, dtype,
                                                 every):
    """run_probed on the kernel backends (the sharded ones over 2 virtual
    shards of the card): the series bitwise equal to run() with
    probe_values between chunks, the final state bitwise equal to an
    unprobed run's; every step counted in the passes of the backends'
    temporal forms (cuda: the session's default depth; sharded-cuda: the
    interior and two 3-row bands of each 8-row shard; -rdma and -ds64: one
    launch per shard and pass), no one-step launch but where the cuda
    session's default depth runs an advance of one step (every = 1) as
    one."""
    from latticeboltzmann_tpu_torch.models import engine

    if backend.startswith("sharded"):
        mesh = sharded.make_mesh(devices=[cuda_device] * 2)
        monkeypatch.setitem(engine._BACKENDS, backend, (
            sharded.make_cuda_ds_backend(mesh) if backend.endswith("ds64")
            else sharded.make_cuda_backend(mesh, rdma=backend.endswith("rdma"))))
    cfg, walls = _scene("barrier", dtype)
    n = 24

    def sim():
        return Simulation(cfg, walls, backend=backend, allow_experimental=True)

    counts = {"cuda": (fk, "TEMPORAL_STEPS"), "cuda-ds64": (fdk, "TEMPORAL_STEPS"),
              "sharded-cuda": (fk, "EXT_TEMPORAL_STEPS"),
              "sharded-cuda-rdma": (fk, "RDMA_TEMPORAL_STEPS"),
              "sharded-cuda-ds64": (fdk, "EXT_TEMPORAL_STEPS")}[backend]
    before = getattr(*counts)
    one_step = (fdk.EXT_LAUNCHES, fk.EXT_LAUNCHES, fk.RDMA_LAUNCHES, fk.LAUNCHES, fdk.LAUNCHES)
    probed = sim()
    series = probed.run_probed(n, PROBES, every=every)
    # passes of T and one of the rest per sample: each launch counts every
    # step of its pass
    per_step = {"sharded-cuda": 6, "sharded-cuda-rdma": 2, "sharded-cuda-ds64": 2}.get(backend, 1)
    # the cuda session runs a rest of one step at its default depth as a
    # one-step launch
    depth = probed._session.temporal if backend == "cuda" else None
    ones = 0 if depth is None else n if depth == 1 else n // every * (every % depth == 1)
    assert (fdk.EXT_LAUNCHES, fk.EXT_LAUNCHES, fk.RDMA_LAUNCHES, fk.LAUNCHES - ones,
            fdk.LAUNCHES) == one_step
    assert getattr(*counts) - before == (n - ones) * per_step
    assert series.shape == (n // every, len(PROBES), 3) and probed.steps_done == n
    ref = sim()
    want = np.stack([ref.run(every).probe_values(PROBES) for _ in range(n // every)])
    np.testing.assert_array_equal(series, want)
    np.testing.assert_array_equal(probed.state(), sim().run(n).state())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_session_probe_gather_equals_its_plain_version(cuda_device, dtype):
    """The session's gather from its live buffer on the card equals
    stream_collide.probe_values of the state on the CPU, bitwise; the ds
    session's float64 gather equals that of the recombined pair."""
    from latticeboltzmann_tpu_torch.ops import ds_engine, stream_collide

    cfg, walls = _scene("barrier", dtype)
    sess = fk.Session(cfg, walls, device=cuda_device, wall_spec=geometry.infer_spec(walls))
    sess.load(_perturbed(cfg, cuda_device))
    sess.advance(5)
    sites = sess.probe_sites(PROBES)
    got = sess.probe_values(sites)
    want = stream_collide.probe_values(sess.state().cpu(), PROBES)
    assert got.dtype == torch.float32 and torch.equal(got.cpu(), want)
    cfg64 = LatticeConfig(nx=cfg.nx, ny=cfg.ny, dtype=np.float64)
    ds = fdk.Session(cfg64, walls, device=cuda_device)
    ds.load(df64.from_f64(initial_state(cfg64), cuda_device))
    ds.advance(5)
    got = ds.probe_values(ds.probe_sites(PROBES))
    want = stream_collide.probe_values(ds_engine.recombine(ds.state()).cpu(), PROBES)
    assert got.dtype == torch.float64 and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_a_bench_suite_row_is_sane(cuda_device):
    """Row 8 of bench_suite (400x2000 f32, cuda) at a short length: sane,
    with every timing key and the card's line."""
    from latticeboltzmann_tpu_torch import bench_suite

    rows = bench_suite.run_rows([bench_suite.CONFIGS[7]], 240, "card", emit=lambda line: None)
    (row,) = rows
    assert row["sane"] and row["backend"] == "cuda" and row["mlups"] > 0
    assert row["slope_us_per_step"] > 0 and len(row["e2e_runs_s"]) >= bench_suite.E2E_RUNS


@pytest.mark.cuda
@pytest.mark.parametrize("backend,precision,dtype", [("cuda", "f32", np.float32),
                                                      ("cuda-ds64", "f64", np.float64),
                                                      ("cuda", "f64", np.float64)])
def test_cli_resumes_on_the_card(cuda_device, tmp_path, capsys, backend, precision, dtype):
    """The CLI at 64x128 on the card, as chip_smoke's phase 28(b): 20 steps
    with a snapshot and a checkpoint, --resume latest for 20 more, against
    an unbroken 40-step run (bitwise; the ds pair within 1e-11 relative,
    since a float64 checkpoint is split again at load time); every step
    counted in a pass of the temporal form (the session's default depth
    in f32, DS_TEMPORAL on cuda-ds64) with no one-step launch, or on cuda
    with float64 a counted step of the torch engine (a float64 checkpoint
    resumes under --backend cuda); the
    snapshot byte-equal to write_snapshot_csv of a Simulation run's
    speed_squared()."""
    from latticeboltzmann_tpu_torch import cli
    from latticeboltzmann_tpu_torch.utils import checkpoint, viz

    scene = ["--nx", "64", "--ny", "128", "--geometry", "barrier", "--backend", backend,
             "--precision", precision, "--warmup", "2", "--print-stats-every", "0",
             "--debug-nans"]
    ck, ck1, data = tmp_path / "ck", tmp_path / "ck1", tmp_path / "data"
    def launched():
        # the steps of the ds path's passes (the temporal form), the float64
        # path's engine steps, or the steps of the f32 path's passes (the
        # session's default depth)
        if backend == "cuda-ds64":
            return fdk.TEMPORAL_STEPS
        return fk.F64_STEPS if dtype == np.float64 else fk.TEMPORAL_STEPS

    before, one_step_before, kernel_before = launched(), fdk.LAUNCHES, fk.LAUNCHES
    assert cli.main(scene + ["--steps", "20", "--checkpoint-every", "20", "--checkpoint-dir",
                             str(ck), "--save-lattice-every", "20", "--snapshot-dir",
                             str(data)]) == 0
    assert cli.main(scene + ["--resume", "latest", "--checkpoint-dir", str(ck), "--steps", "20",
                             "--checkpoint-every", "20"]) == 0
    assert cli.main(scene + ["--steps", "40", "--checkpoint-every", "40", "--checkpoint-dir",
                             str(ck1)]) == 0
    assert launched() - before == 22 + 22 + 42
    if backend == "cuda-ds64":
        assert fdk.LAUNCHES == one_step_before
    else:
        assert fk.LAUNCHES == kernel_before
    assert "resumed from" in capsys.readouterr().out
    _, resumed, _, _ = checkpoint.load(ck / "40.lbmckpt")
    _, unbroken, _, _ = checkpoint.load(ck1 / "40.lbmckpt")
    if backend == "cuda-ds64":
        np.testing.assert_allclose(resumed, unbroken, rtol=1e-11, atol=0)
    else:
        np.testing.assert_array_equal(resumed, unbroken)
    cfg = LatticeConfig(nx=64, ny=128, dtype=dtype)
    sim = Simulation(cfg, geometry.build("barrier", 64, 128), backend=backend).run(20)
    viz.write_snapshot_csv(tmp_path / "want.csv", sim.speed_squared())
    assert (data / "20.csv").read_bytes() == (tmp_path / "want.csv").read_bytes()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "ds64"])
def test_sharded_checkpoint_on_the_card(cuda_device, tmp_path, monkeypatch, kind):
    """A sharded run on 4 virtual shards of the card saved shard by shard
    (utils/checkpoint.py, format "sharded") and resumed through
    load_shards onto 2 shards: bitwise equal to the unbroken run, and
    neither the save nor the restore allocates on the card."""
    from latticeboltzmann_tpu_torch.models import engine
    from latticeboltzmann_tpu_torch.utils import checkpoint

    dtype = {"f32": np.float32, "bf16": "bfloat16", "ds64": np.float64}[kind]
    backend = "sharded-cuda-ds64" if kind == "ds64" else "sharded-cuda"
    make = sharded.make_cuda_ds_backend if kind == "ds64" else sharded.make_cuda_backend
    cfg = LatticeConfig(nx=64, ny=128, dtype=dtype)
    walls = geometry.build("barrier", 64, 128)

    def rise(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    monkeypatch.setitem(engine._BACKENDS, backend,
                        make(sharded.make_mesh(devices=[cuda_device] * 4)))
    sim = Simulation(cfg, walls, backend=backend).run(12)
    d, saved = rise(lambda: checkpoint.save(tmp_path, 12, sim._session.shards(), walls, cfg,
                                            format="sharded"))
    want = sim.run(12).state()
    mesh = sharded.make_mesh(devices=[cuda_device] * 2)
    monkeypatch.setitem(engine._BACKENDS, backend, make(mesh))
    other = Simulation(cfg, walls, backend=backend)
    _, loaded = rise(lambda: setattr(
        other, "f", checkpoint.load_shards(d, mesh, pair=kind == "ds64")[1]))
    np.testing.assert_array_equal(other.run(12).state(), want)
    assert saved == 0 and loaded == 0


@pytest.mark.cuda
def test_scaling_trace_reads_the_card(cuda_device, tmp_path, monkeypatch):
    """scripts/scaling.py's trace of sharded-cuda on 2 virtual shards of
    the card: the halo copies HaloExchange.start issues are strided copy
    kernels, the compute lbm_ kernels, and on one card (one stream) no
    halo time overlaps a kernel."""
    from latticeboltzmann_tpu_torch.models import engine
    from latticeboltzmann_tpu_torch.scripts import scaling

    monkeypatch.setitem(engine._BACKENDS, "sharded-cuda",
                        sharded.make_cuda_backend(sharded.make_mesh(devices=[cuda_device] * 2)))
    cfg = LatticeConfig(nx=64, ny=128, dtype=np.float32)
    sim = Simulation(cfg, geometry.build("barrier", 64, 128), backend="sharded-cuda")
    s = scaling.traced(sim, 6, tmp_path)
    assert 0 < s.halo_us < s.device_us and s.compute_us > 0
    assert s.halo_us + s.compute_us == pytest.approx(s.device_us, rel=1e-9)
    assert all("direct_copy_kernel_cuda" in scaling.short_name(n) for n in s.halo_names)
    assert s.overlap_us == 0.0
