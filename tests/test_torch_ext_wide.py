"""The wide forms of the row-sharded stream-collide kernels
(csrc/lbm_wide_ext_step.cu: the ext-halo and rdma kernels with several
columns per thread and 16-byte accesses), as far as the CPU reaches them:
their plain version step_reference_ext_wide, which assembles each shard's
pull the way the kernels do (aligned V-column vectors, neighbour elements,
wrap loads, the forcing guard in the two owners that pull from column 0,
halo rows with their own guards and class rows, the wall spec at global
rows), the rdma plain version's wide form, the sharded paths with the wide
form forced, the host's choice of form and the wrappers' refusals.
tests/test_torch_cuda.py holds the kernels themselves, on a card.

Tolerance everywhere: bitwise. step_reference_ext_wide moves and adds the
same float32 values in the same order as step_reference_ext, for float32
and bf16 storage; the sharded paths are held to the JAX ppermute path in
interpret mode bitwise, as tests/test_torch_rdma.py holds them.
"""

import functools

import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu import Simulation as JaxSimulation
from latticeboltzmann_tpu.models import engine as jax_engine
from latticeboltzmann_tpu.parallel import sharded as jax_sharded
from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.models import engine
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
from latticeboltzmann_tpu_torch.parallel import sharded
from latticeboltzmann_tpu_torch.utils.interop import state_tensor

torch.set_num_threads(1)

NX, NY = 24, 40
DTYPES = [np.float32, "bfloat16"]


def _walls():
    """Channel walls (so shard 0's top halo row and the last shard's bottom
    halo row are wall rows) and a block on columns 0-2 across the 4-shard
    boundary at row 6."""
    w = geometry.channel(NX, NY)
    w[4:9, 0:3] = True
    return w


def _state(cfg, seed=0):
    """Rest equilibrium times 5% noise, in the config's storage dtype. At
    column 0 the forcing guard is off on both sides of the boundary at row
    18 (4 shards), by f6 below its decrement; at the boundary at row 12 (2
    and 4 shards) it is on in the fluid rows, the halo rows included."""
    rng = np.random.default_rng(seed)
    f = initial_state(cfg) * (1 + 0.05 * rng.uniform(-1, 1, (9, cfg.nx, cfg.ny)))
    f[6, [17, 18], 0] = 1e-6
    return state_tensor(f.astype(np.float32), cfg.dtype, "cpu")


def _geoms(kind, n):
    """Each of n shards' geometry: None, the wall spec, or a ShardPlane of
    the walls (or of the slip codes: the top wall row slip_x, a slip_y
    block across the first boundary)."""
    L = NX // n
    if kind == "none":
        return [None] * n
    if kind == "spec":
        return [geometry.infer_spec(_walls())] * n
    walls = _walls()
    if kind == "slip":
        slip_x, slip_y = np.zeros_like(walls), np.zeros_like(walls)
        slip_x[0], walls[0] = True, False
        slip_y[L - 1:L + 1, 20:23] = True
        plane = torch.as_tensor(fk.class_plane(walls, slip_x, slip_y))
        assert set(np.unique(plane.numpy())) == {0, 1, 2, 3}
    else:
        plane = torch.as_tensor(walls.astype(np.uint8))
    return [fk.ShardPlane(plane[k * L:(k + 1) * L].contiguous(), plane[(k * L - 1) % NX].clone(),
                          plane[(k * L + L) % NX].clone()) for k in range(n)]


def _shards(f, n):
    L = f.shape[1] // n
    return [f[:, k * L:(k + 1) * L].contiguous() for k in range(n)]


def _halos(shards):
    n = len(shards)
    return [(shards[(k - 1) % n][:, -1].contiguous(), shards[(k + 1) % n][:, 0].contiguous())
            for k in range(n)]


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("v", [2, 4, 8])
@pytest.mark.parametrize("kind", ["none", "plane", "slip", "spec"])
@pytest.mark.parametrize("n", [2, 4])
def test_step_reference_ext_wide_equals_step_reference_ext(n, kind, v, dtype):
    cfg = LatticeConfig(nx=NX, ny=NY, dtype=dtype, accel=0.005)
    geoms = _geoms(kind, n)
    f = _state(cfg)
    L = NX // n
    for _ in range(2):
        shards = _shards(f, n)
        outs = []
        for k, (src, halo) in enumerate(zip(shards, _halos(shards))):
            want = fk.step_reference_ext(src, halo, geoms[k], cfg, row_offset=k * L)
            got = fk.step_reference_ext_wide(src, halo, geoms[k], cfg, v, row_offset=k * L)
            assert got.dtype == src.dtype and got.shape == src.shape
            assert torch.equal(_bits(got), _bits(want))
            outs.append(want)
        f = torch.cat(outs, dim=1)
    # and the shards together are the single-chip step
    want = _state(cfg)
    spec = geoms[0] if kind == "spec" else None
    plane = None if kind in ("none", "spec") else torch.cat([g.plane for g in geoms])
    for _ in range(2):
        want = fk.step_reference(want, plane, cfg, wall_spec=spec)
    assert torch.equal(_bits(f), _bits(want))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [2, 4])
def test_rdma_plain_version_wide_equals_narrow_over_a_ring(n, dtype):
    cfg = LatticeConfig(nx=NX, ny=NY, dtype=dtype, accel=0.005)
    geoms = _geoms("spec", n)
    L = NX // n
    srcs = _shards(_state(cfg), n)
    for step in (1, 2, 3):
        ends = [fk.rdma_end(cfg, "cpu") for _ in range(n)]
        for e in ends:
            e.flags.fill_(step - 1)
        narrow = fk.step_reference_rdma(srcs, ends, geoms, cfg, step)
        for k in range(n):
            wide = fk.rdma_compute_reference(srcs[k], ends[k], geoms[k], cfg, step,
                                             row_offset=k * L, form="wide")
            assert torch.equal(_bits(wide), _bits(narrow[k]))
        srcs = narrow


# tests/test_torch_rdma.py's scene for the JAX comparison: the JAX kernel
# needs 8-row tiles per shard, so 32 rows
JAX_NX, JAX_STEPS = 32, 7


def _jax_scene():
    """(walls, f0): a channel with a barrier across the 2-shard boundary at
    row 16, the rest state with the forcing guard off at column 0 on both
    sides of the boundaries at rows 8 and 16."""
    walls = geometry.channel(JAX_NX, NY)
    walls[12:20, 10:13] = True
    f0 = initial_state(LatticeConfig(nx=JAX_NX, ny=NY, dtype=np.float32))
    f0[6, [7, 8, 15, 16], 0] = 1e-6
    return walls, f0


@pytest.mark.parametrize("backend", ["sharded-cuda", "sharded-cuda-rdma"])
def test_sharded_paths_with_the_wide_form_bitwise_jax_sharded_pallas_interpret(
        monkeypatch, backend):
    """Both sharded kernel paths over a CPU mesh of 2 shards with the wide
    form forced (every launcher asked for form="wide", which on CPU tensors
    runs step_reference_ext_wide) equal the JAX ppermute path in interpret
    mode over a mesh of 2, float32, the wall spec (both facades infer
    it)."""
    n, steps = 2, JAX_STEPS
    monkeypatch.setitem(jax_engine._BACKENDS, "sharded-pallas-interpret",
                        jax_sharded.make_pallas_backend(jax_sharded.make_mesh(n), interpret=True))
    walls, f0 = _jax_scene()
    ref = JaxSimulation(JaxConfig(nx=JAX_NX, ny=NY, dtype=np.float32), walls,
                        backend="sharded-pallas-interpret", f0=f0)
    assert ref.wall_spec is not None
    want = np.asarray(ref.run(steps).state())
    calls = []
    wide_plain = fk.step_reference_ext_wide

    def counted(*args, **kw):
        calls.append(args[4])
        return wide_plain(*args, **kw)

    monkeypatch.setattr(fk, "step_reference_ext_wide", counted)
    monkeypatch.setattr(fk, "ext_launcher", functools.partial(fk.ext_launcher, form="wide"))
    monkeypatch.setattr(fk, "rdma_launcher", functools.partial(fk.rdma_launcher, form="wide"))
    mesh = sharded.make_mesh(devices=["cpu"] * n)
    monkeypatch.setitem(engine._BACKENDS, backend,
                        sharded.make_cuda_backend(mesh, rdma=backend.endswith("rdma")))
    monkeypatch.setattr(engine, "_KERNEL_BACKENDS", set())  # a CPU mesh, for the tests
    cfg = LatticeConfig(nx=JAX_NX, ny=NY, dtype=np.float32)
    sim = Simulation(cfg, walls, backend=backend, device="cpu", f0=f0, allow_experimental=True)
    assert sim.wall_spec == ref.wall_spec
    got = sim.run(steps).state()
    np.testing.assert_array_equal(got, want)
    # every shard's step went through the wide plain version (the overlap
    # schedule: interior and both edge launches)
    per_step = n * (3 if backend == "sharded-cuda" else 1)
    assert calls == [fk.WIDE_COLUMNS[torch.float32]] * steps * per_step


def _offset_view(shape, dtype, elements):
    """A contiguous tensor of `shape` that starts `elements` elements into
    a larger buffer."""
    size = int(np.prod(shape))
    return torch.zeros(size + elements, dtype=dtype)[elements:].view(shape)


def _ext_case(case, dtype=torch.float32):
    """(src, dst, halo, geom, cfg) of a one-shard ext-halo launch at 8 x
    NY, one buffer made unaligned or NY changed by `case`."""
    ny = {"odd_ny": 37, "ny_not_a_multiple_of_8": 12}.get(case, NY)
    cfg = LatticeConfig(nx=8, ny=ny, dtype="bfloat16" if dtype == torch.bfloat16 else np.float32)
    src = state_tensor(initial_state(cfg), cfg.dtype, "cpu")
    dst = torch.empty_like(src)
    halo = (src[:, -1].clone(), src[:, 0].clone())
    plane = torch.as_tensor(geometry.channel(8, ny).astype(np.uint8))
    geom = fk.ShardPlane(plane, plane[-1].clone(), plane[0].clone())
    if case == "unaligned_src":
        src = _offset_view(src.shape, src.dtype, 1).copy_(src)
    elif case == "unaligned_dst":
        dst = _offset_view(dst.shape, dst.dtype, 2)
    elif case == "unaligned_halo":
        halo = (_offset_view(halo[0].shape, src.dtype, 1).copy_(halo[0]), halo[1])
    elif case == "unaligned_plane":
        geom = geom._replace(plane=_offset_view(plane.shape, torch.uint8, 3).copy_(plane))
    elif case == "unaligned_class_row":
        geom = geom._replace(bot=_offset_view(plane[0].shape, torch.uint8, 5).copy_(plane[0]))
    return src, dst, halo, geom, cfg


EXT_CASES = ["odd_ny", "ny_not_a_multiple_of_8", "unaligned_src", "unaligned_dst",
             "unaligned_halo", "unaligned_plane"]
# read a byte at a time (the forcing guard), so their alignment does not count
WIDE_CASES = ["aligned", "unaligned_class_row"]


@pytest.mark.parametrize("case", WIDE_CASES + EXT_CASES)
def test_ext_launcher_form_follows_shape_and_pointers(case):
    """The form a call launches: wide where NY is a multiple of the
    storage's column count and every buffer read or written by vectors is
    16-byte aligned, else narrow; with either form the call writes the
    same rows. On the CPU form=None runs step_reference_ext."""
    dtype = torch.bfloat16 if case == "ny_not_a_multiple_of_8" else torch.float32
    src, dst, halo, geom, cfg = _ext_case(case, dtype)
    call = fk.ext_launcher(src, dst, halo, geom, cfg)
    assert call.form == ("wide" if case in WIDE_CASES else "narrow")
    # an interior launch reads no halo row: an unaligned one does not count
    interior = fk.ext_launcher(src, dst, None, geom, cfg, row0=1, rows=6)
    assert interior.form == ("wide" if case in WIDE_CASES + ["unaligned_halo"] else "narrow")
    # a launch of one row takes the narrow form unless asked for the wide
    assert fk.ext_launcher(src, dst, halo, geom, cfg, row0=0, rows=1).form == "narrow"
    if case in WIDE_CASES:
        assert fk.ext_launcher(src, dst, halo, geom, cfg, row0=0, rows=1, form="wide").form == "wide"
    call()
    want = fk.step_reference_ext(src, halo, geom, cfg)
    assert torch.equal(_bits(dst), _bits(want))
    before = (fk.EXT_LAUNCHES, dict(fk.EXT_FORM_LAUNCHES))
    fk.ext_launcher(src, dst, halo, geom, cfg, form="narrow")()
    assert torch.equal(_bits(dst), _bits(want))
    assert (fk.EXT_LAUNCHES, dict(fk.EXT_FORM_LAUNCHES)) == before  # the CPU counts nothing


@pytest.mark.parametrize("case", EXT_CASES + ["unknown_form"])
def test_ext_launcher_refuses_the_wide_form_where_it_cannot_run(case):
    src, dst, halo, geom, cfg = _ext_case(
        "aligned" if case == "unknown_form" else case,
        torch.bfloat16 if case == "ny_not_a_multiple_of_8" else torch.float32)
    with pytest.raises(ValueError, match="form"):
        fk.ext_launcher(src, dst, halo, geom, cfg, form="broad" if case == "unknown_form" else "wide")


def _ring_of_two(case):
    cfg = LatticeConfig(nx=16, ny=NY, dtype=np.float32)
    f = state_tensor(initial_state(cfg), cfg.dtype, "cpu")
    srcs = _shards(f, 2)
    dsts = [torch.empty_like(s) for s in srcs]
    ends = [fk.rdma_end(cfg, "cpu") for _ in range(2)]
    if case == "unaligned_comm_rows":
        top = _offset_view(ends[0].top.shape, ends[0].top.dtype, 1)
        ends[0] = ends[0]._replace(top=top)
    elif case == "unaligned_src":
        srcs[0] = _offset_view(srcs[0].shape, srcs[0].dtype, 3).copy_(srcs[0])
    return cfg, srcs, dsts, ends


@pytest.mark.parametrize("case", ["aligned", "unaligned_comm_rows", "unaligned_src"])
def test_rdma_launcher_form_follows_pointers_and_refuses_wide(case, monkeypatch):
    """The rdma launcher picks by the same rule over src, dst, its comm rows
    and the neighbours' it writes; form="wide" raises where the rule does
    not hold. Both forms' plain versions step the ring alike."""
    cfg, srcs, dsts, ends = _ring_of_two(case)
    calls = [fk.rdma_launcher(srcs[k], dsts[k], ends[k], ends[1 - k], ends[1 - k], None, cfg,
                              row_offset=8 * k) for k in range(2)]
    # shard 1 writes shard 0's comm rows: its rule sees them too
    assert [c.form for c in calls] == (["wide"] * 2 if case == "aligned" else
                                       ["narrow"] * 2 if case == "unaligned_comm_rows" else
                                       ["narrow", "wide"])
    if case != "aligned":
        with pytest.raises(ValueError, match="form"):
            fk.rdma_launcher(srcs[0], dsts[0], ends[0], ends[1], ends[1], None, cfg, form="wide")
        return
    wide = [fk.rdma_launcher(srcs[k], dsts[k], ends[k], ends[1 - k], ends[1 - k], None, cfg,
                             row_offset=8 * k, form="wide") for k in range(2)]
    outs = {}
    for label, ring in (("default", calls), ("wide", wide)):
        for e in ends:
            fk.rdma_reset(e)
        for c in ring:
            c.send(1)
        for c in ring:
            c.compute(1)
        outs[label] = torch.cat(dsts, dim=1).clone()
    assert torch.equal(outs["default"], outs["wide"])
    assert torch.equal(outs["wide"], fk.step_reference(torch.cat(srcs, dim=1), None, cfg))
