"""The shard-by-shard checkpoint (utils/checkpoint.py, format "sharded")
on CPU meshes of virtual shards, the kernel sessions on their plain
versions, in float32, bf16 and the pair-DP tier (ds64).

Bars: bitwise throughout. The state is Markov, so a run saved from 4
shards after n steps and restored onto 4, 2, 8 or 1 shards continues
bitwise equal to the unbroken n + m steps; the ds pair is saved as its
float64 recombination, and the fast tier's pairs split back to
themselves (measured here: the resumed run is bitwise). load() of a
.lbmshards/ directory is the raw checkpoint of Simulation.state(), and
the JAX package's load() of a raw checkpoint it wrote from that state.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu.utils import checkpoint as jckpt
from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.models import engine
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import df64
from latticeboltzmann_tpu_torch.parallel import sharded
from latticeboltzmann_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

NX, NY = 32, 48
SAVED_AT, MORE = 5, 4
KINDS = {"f32": (np.float32, np.float32), "bf16": ("bfloat16", jnp.bfloat16),
         "ds64": (np.float64, np.float64)}


def cpu_mesh(n):
    return sharded.make_mesh(devices=["cpu"] * n)


def _cfg(kind):
    return LatticeConfig(nx=NX, ny=NY, dtype=KINDS[kind][0])


def _walls():
    return geometry.channel_with_barrier(NX, NY)


def _session(kind, n, rdma=False):
    cfg, walls = _cfg(kind), _walls()
    if kind == "ds64":
        return sharded.ShardedDSSession(cfg, walls, mesh=cpu_mesh(n), device="cpu")
    if rdma:
        return sharded.ShardedRdmaSession(cfg, walls, mesh=cpu_mesh(n), device="cpu")
    return sharded.ShardedSession(cfg, walls, mesh=cpu_mesh(n), device="cpu")


def _start(kind):
    f = initial_state(_cfg(kind))
    if kind == "ds64":
        return df64.from_f64(f)
    return torch.as_tensor(f).to(torch.bfloat16 if kind == "bf16" else torch.float32)


def _equal(a, b):
    if isinstance(a, df64.DS):
        return torch.equal(a.hi, b.hi) and torch.equal(a.lo, b.lo)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("target", [4, 2, 8, 1])
@pytest.mark.parametrize("kind", list(KINDS))
def test_resume_onto_any_shard_count_is_bitwise(tmp_path, kind, target):
    src = _session(kind, 4)
    src.load(_start(kind))
    src.advance(SAVED_AT)
    d = checkpoint.save(tmp_path, SAVED_AT, src.shards(), _walls(), _cfg(kind), format="sharded")
    assert d.name == f"{SAVED_AT}.lbmshards"
    assert sorted(p.name for p in d.iterdir()) == [
        "f.0.raw", "f.1.raw", "f.2.raw", "f.3.raw", "meta.json", "walls.raw"]
    src.advance(MORE)
    want = src.state()

    step, shards, walls, cfg = checkpoint.load_shards(d, cpu_mesh(target), pair=kind == "ds64")
    assert step == SAVED_AT and cfg == _cfg(kind) and len(shards) == target
    np.testing.assert_array_equal(walls, _walls())
    dst = _session(kind, target)
    dst.load(shards)
    dst.advance(MORE)
    assert _equal(dst.state(), want)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_rdma_session_saves_and_restores_shard_by_shard(tmp_path, kind):
    """ShardedRdmaSession (passes need 2 T + 1 rows a shard: 8 and 16 here)
    through its shards() and load(), onto 2 shards and back onto 4."""
    src = _session(kind, 4, rdma=True)
    src.load(_start(kind))
    src.advance(SAVED_AT)
    d = checkpoint.save(tmp_path, SAVED_AT, src.shards(), _walls(), _cfg(kind), format="sharded")
    src.advance(MORE)
    for n in (2, 4):
        dst = _session(kind, n, rdma=True)
        dst.load(checkpoint.load_shards(d, cpu_mesh(n))[1])
        dst.advance(MORE)
        assert _equal(dst.state(), src.state())


def test_facade_restores_through_its_session(tmp_path, monkeypatch):
    """Simulation.f takes the shards of load_shards on a sharded kernel
    backend (its session's load), and a whole state cut at save equals
    the shards saved as they are."""
    cfg = _cfg("f32")
    monkeypatch.setitem(engine._BACKENDS, "_sharded_kernel",
                        sharded.make_cuda_backend(cpu_mesh(4)))
    sim = Simulation(cfg, _walls(), backend="_sharded_kernel", device="cpu").run(SAVED_AT)
    a = checkpoint.save(tmp_path / "a", SAVED_AT, sim._session.shards(), _walls(), cfg,
                        format="sharded")
    b = checkpoint.save(tmp_path / "b", SAVED_AT, sim.f, _walls(), cfg, format="sharded",
                        shards=cpu_mesh(4))
    for p in a.iterdir():
        assert p.read_bytes() == (b / p.name).read_bytes(), p.name
    want = sim.run(MORE).state()
    other = Simulation(cfg, _walls(), backend="_sharded_kernel", device="cpu")
    other.f = checkpoint.load_shards(a, cpu_mesh(4))[1]
    np.testing.assert_array_equal(other.run(MORE).state(), want)


def test_shards_are_the_live_buffers():
    sess = _session("ds64", 4)
    sess.load(_start("ds64"))
    sess.advance(1)
    shards = sess.shards()
    assert len(shards) == 4 and all(s.hi.shape == (9, NX // 4, NY) for s in shards)
    assert shards[2].hi.data_ptr() == sess._bufs[sess._parity][0][2].data_ptr()
    joined = sess.state()
    assert torch.equal(torch.cat([s.hi for s in shards], dim=1), joined.hi)


@pytest.mark.parametrize("kind", list(KINDS))
def test_load_equals_raw_and_jax_load(tmp_path, monkeypatch, kind):
    """load() of a .lbmshards/ directory: the raw checkpoint of
    Simulation.state(), bitwise, and the JAX load() of a raw checkpoint
    the JAX package wrote from the same numpy state; the JAX
    _cfg_from_meta reads the new meta.json."""
    cfg = _cfg(kind)
    run = (sharded.make_cuda_ds_backend(cpu_mesh(4)) if kind == "ds64"
           else sharded.make_cuda_backend(cpu_mesh(4)))
    monkeypatch.setitem(engine._BACKENDS, "_ckpt", run)
    if kind == "ds64":
        monkeypatch.setattr(engine, "_DS_BACKENDS", engine._DS_BACKENDS | {"_ckpt"})
    sim = Simulation(cfg, _walls(), backend="_ckpt", device="cpu").run(SAVED_AT)
    shards = checkpoint.save(tmp_path / "s", SAVED_AT, sim._session.shards(), _walls(), cfg,
                             format="sharded")
    state = sim.state()
    raw = checkpoint.save(tmp_path / "r", SAVED_AT, state, _walls(), cfg)
    got, want = checkpoint.load(shards), checkpoint.load(raw)
    assert got[0] == want[0] == SAVED_AT and got[3] == want[3] == cfg
    assert got[1].dtype == want[1].dtype
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])

    jdtype = KINDS[kind][1]
    jcfg = JaxConfig(nx=NX, ny=NY, dtype=jdtype)
    jdir = jckpt.save(tmp_path / "j", SAVED_AT, np.asarray(state).astype(jdtype), _walls(), jcfg)
    step, jf, jwalls, jcfg2 = jckpt.load(jdir)
    assert step == SAVED_AT and jcfg2 == jcfg
    np.testing.assert_array_equal(np.asarray(jf).astype(got[1].dtype), got[1])
    np.testing.assert_array_equal(jwalls, got[2])
    meta = json.loads((shards / "meta.json").read_text())
    assert meta["shards"] == 4 and meta["rows_per_shard"] == NX // 4
    assert meta["f_shape"] == [9, NX, NY]
    assert jckpt._cfg_from_meta(meta) == jcfg


def test_latest_orders_every_format_by_step(tmp_path):
    for name in ("3.lbmckpt", "12.orbax", "7.lbmshards", "20.lbmshards", "9.txt"):
        (tmp_path / name).mkdir()
    assert checkpoint.latest(tmp_path).name == "20.lbmshards"
    (tmp_path / "25.lbmckpt").mkdir()
    assert checkpoint.latest(tmp_path).name == "25.lbmckpt"
    (tmp_path / "30.orbax").mkdir()
    assert checkpoint.latest(tmp_path).name == "30.orbax"


def test_missing_or_wrong_sized_shard_file_raises(tmp_path):
    cfg = _cfg("f32")
    f = _start("f32")
    d = checkpoint.save(tmp_path, 1, f, _walls(), cfg, format="sharded", shards=4)
    (d / "f.2.raw").write_bytes((d / "f.2.raw").read_bytes()[:-4])
    for call in (lambda: checkpoint.load(d), lambda: checkpoint.load_shards(d, cpu_mesh(2))):
        with pytest.raises(ValueError, match="f.2.raw holds"):
            call()
    (d / "f.2.raw").unlink()
    for call in (lambda: checkpoint.load(d), lambda: checkpoint.load_shards(d, cpu_mesh(4))):
        with pytest.raises(FileNotFoundError, match="f.2.raw is missing"):
            call()


def test_bad_sharded_inputs_raise(tmp_path):
    cfg = _cfg("f32")
    f = _start("f32")
    with pytest.raises(ValueError, match="not divisible by 5"):
        checkpoint.save(tmp_path, 1, f, _walls(), cfg, format="sharded", shards=5)
    d = checkpoint.save(tmp_path, 1, f, _walls(), cfg, format="sharded", shards=2)
    with pytest.raises(ValueError, match="not divisible by 3"):
        checkpoint.load_shards(d, cpu_mesh(3))
    with pytest.raises(ValueError, match="pair=True splits a float64"):
        checkpoint.load_shards(d, cpu_mesh(2), pair=True)
    sess = _session("f32", 2)
    with pytest.raises(ValueError, match="2 shards for a mesh of 4"):
        _session("f32", 4).load(checkpoint.load_shards(d, cpu_mesh(2))[1])
    with pytest.raises(ValueError, match="the session holds 1"):
        sess.load([df64.from_f64(np.zeros((9, NX // 2, NY)))] * 2)
    with pytest.raises(ValueError, match="no .lbmshards checkpoint"):
        checkpoint.load_shards(checkpoint.save(tmp_path, 2, f, _walls(), cfg), cpu_mesh(1))


@pytest.mark.parametrize("saved,session", [("f32", "bf16"), ("bf16", "f32"), ("ds64", "f32")])
def test_shards_of_another_dtype_raise(tmp_path, saved, session):
    """A session's load() of shards in another storage dtype raises,
    where copy_ would round them."""
    f = torch.as_tensor(initial_state(_cfg(saved))) if saved == "ds64" else _start(saved)
    d = checkpoint.save(tmp_path, 1, f, _walls(), _cfg(saved), format="sharded", shards=2)
    with pytest.raises(ValueError, match="the session holds"):
        _session(session, 2).load(checkpoint.load_shards(d, cpu_mesh(2))[1])
