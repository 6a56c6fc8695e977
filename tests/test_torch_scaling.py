"""The port's scaling script (latticeboltzmann_tpu_torch/scripts/scaling.py)
on the CPU: mode_cpu on virtual CPU shards, the trace reader on chrome
traces built here, and the PREDICTED table's arithmetic.

- mode_cpu at 24x40 and 32x48, 6 steps, on 1, 2, 4 and 8 shards: every
  row bitwise to its unsharded path (the "torch" engine for "sharded" and
  "sharded-sync"; fused_kernel.run_steps, the unsharded kernel's plain
  version, for the kernel session, which is within scaling.ENGINE_BAR,
  1e-6, of the engine), and the engine within 5e-5 of the JAX xla engine
  (tests/test_torch_engine.py:86).
- read_trace on synthetic traces with known intervals: the halo share,
  the overlap share, the compute; a trace with no lbm_ kernel raises; a
  CPU trace of a sharded run holds HaloExchange's spans and no device
  event, and raises too.
- predict: halo bytes, shard heights, and rows worked by hand.
"""

import json

import numpy as np
import pytest
import torch

from latticeboltzmann_tpu import LatticeConfig as JaxConfig
from latticeboltzmann_tpu import Simulation as JaxSimulation
from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.models import engine
from latticeboltzmann_tpu_torch.ops.fused_ds_kernel import DS_TEMPORAL
from latticeboltzmann_tpu_torch.parallel import sharded
from latticeboltzmann_tpu_torch.parallel.sharded import HALO_SPAN, SHARDED_TEMPORAL
from latticeboltzmann_tpu_torch.scripts import scaling

torch.set_num_threads(1)

SCENES = [(24, 40), (32, 48)]
STEPS = 6


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("scene", SCENES, ids=["24x40", "32x48"])
def test_mode_cpu_rows_bitwise(scene, n):
    nx, ny = scene
    lines = []
    rows = scaling.mode_cpu(nx, ny, STEPS, counts=(n,), emit=lines.append)
    assert [r["backend"] for r in rows] == ["sharded", "sharded-sync",
                                            "sharded-cuda session (plain versions)"]
    assert all(r["shards"] == n and r["dev_own"] == 0.0 for r in rows)
    assert rows[0]["dev_engine"] == rows[1]["dev_engine"] == 0.0
    assert rows[2]["dev_engine"] < scaling.ENGINE_BAR
    assert "_scaling" not in engine._BACKENDS
    assert sum(line.startswith(f"| {n} |") for line in lines) == 3


@pytest.mark.parametrize("scene", SCENES, ids=["24x40", "32x48"])
def test_mode_cpu_reference_tracks_jax_xla(scene):
    nx, ny = scene
    walls = geometry.channel_with_barrier(nx, ny)
    ours = Simulation(LatticeConfig(nx=nx, ny=ny, dtype=np.float32), walls, backend="torch",
                      device="cpu").run(STEPS).state()
    ref = JaxSimulation(JaxConfig(nx=nx, ny=ny, dtype=np.float32), walls,
                        backend="xla").run(STEPS).state()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-5)


def _x(name, cat, ts, dur, corr=None, tid=10):
    e = {"ph": "X", "name": name, "cat": cat, "pid": 1, "tid": tid, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(tmp_path, events, name="t.pt.trace.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events + [{"ph": "M", "name": "process_name"}]}))
    return path


LBM = "void (anonymous namespace)::lbm_temporal_steps_ext<float, 2>(float const*, float*)"


def test_kernel_function_names():
    assert scaling.kernel_function(LBM) == "lbm_temporal_steps_ext"
    assert scaling.kernel_function("lbm_copy_direct") == "lbm_copy_direct"
    assert scaling.kernel_function(
        "void at::native::elementwise_kernel<128, 2, at::native::lbm_like>(int)") == \
        "elementwise_kernel"
    copy = ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
            "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)>(int)")
    assert scaling.short_name(copy) == "elementwise_kernel [direct_copy_kernel_cuda]"
    assert scaling.short_name(LBM) == "lbm_temporal_steps_ext"
    assert scaling.short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD (Device -> Device)"


def _known_events(compute=LBM):
    """A halo span around a copy and a strided copy kernel's launches, an
    lbm_ kernel launched outside it that overlaps 10 of their 15 us, an
    eager kernel, and a launch inside another thread's span time."""
    return [
        _x(HALO_SPAN, "user_annotation", 100, 10),
        _x("cudaMemcpyAsync", "cuda_runtime", 102, 1, corr=1),
        _x("cudaLaunchKernel", "cuda_runtime", 105, 1, corr=2),
        _x("cudaLaunchKernel", "cuda_runtime", 112, 1, corr=3),
        _x("cudaLaunchKernel", "cuda_runtime", 115, 1, corr=4),
        _x("cudaLaunchKernel", "cuda_runtime", 104, 1, corr=5, tid=11),
        _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 200, 10, corr=1, tid=7),
        _x("direct_copy_kernel_cuda", "kernel", 215, 5, corr=2, tid=7),
        _x(compute, "kernel", 205, 20, corr=3, tid=8),
        _x("elementwise_kernel", "kernel", 300, 30, corr=4, tid=7),
        _x(compute, "kernel", 400, 40, corr=5, tid=8),
        _x(HALO_SPAN, "gpu_user_annotation", 200, 20, tid=7),
    ]


def test_read_trace_known_shares(tmp_path):
    s = scaling.read_trace(_trace(tmp_path, _known_events()))
    assert s.device_us == 10 + 5 + 20 + 30 + 40
    assert s.halo_us == 15 and s.compute_us == 60
    assert s.overlap_us == 10
    assert s.halo_share == pytest.approx(15 / 105, rel=1e-12)
    assert s.overlap_share == pytest.approx(10 / 15, rel=1e-12)
    assert s.top(2) == [(LBM, 60), ("elementwise_kernel", 30)]
    assert s.halo_names == {"Memcpy DtoD (Device -> Device)": 10, "direct_copy_kernel_cuda": 5}
    # the eager paths' compute is every kernel outside the span
    e = scaling.read_trace(_trace(tmp_path, _known_events()), "")
    assert e.compute_us == 90 and e.halo_us == 15 and e.overlap_us == 10


def test_read_trace_without_lbm_kernel_raises(tmp_path):
    path = _trace(tmp_path, _known_events(compute="some_other_kernel"))
    with pytest.raises(ValueError, match="no lbm_\\* kernel event"):
        scaling.read_trace(path)
    empty = _trace(tmp_path, [_x(HALO_SPAN, "user_annotation", 0, 5)], "e.pt.trace.json")
    with pytest.raises(ValueError, match="no kernel event"):
        scaling.read_trace(empty, "")


def test_cpu_trace_has_halo_spans_and_no_device_events(tmp_path, monkeypatch):
    """HaloExchange.start opens HALO_SPAN in a real trace (one per step of
    the eager runner); a CPU run has no device event, so the reader
    raises rather than report a share of 0."""
    cfg = LatticeConfig(nx=24, ny=40, dtype=np.float32)
    monkeypatch.setitem(engine._BACKENDS, "_traced",
                        sharded.make_backend(sharded.make_mesh(devices=["cpu"] * 2)))
    sim = Simulation(cfg, geometry.channel_with_barrier(24, 40), backend="_traced", device="cpu")
    with pytest.raises(ValueError, match="no kernel event"):
        scaling.traced(sim, 3, tmp_path, "")
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = [e.get("name") for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names.count(HALO_SPAN) == 3


def test_predict_halo_bytes_and_heights():
    assert scaling.halo_bytes(4000, SHARDED_TEMPORAL[torch.float32], 4) == 432_000
    assert scaling.halo_bytes(4000, SHARDED_TEMPORAL[torch.bfloat16], 2) == 144_000
    assert scaling.halo_bytes(4000, DS_TEMPORAL, 4, components=2) == 1_152_000
    assert scaling.shard_heights(400) == {1: 400, 2: 200, 4: 100, 8: 50}
    assert scaling.shard_heights(800) == {1: 800, 2: 400, 4: 200, 8: 100}


def test_predict_rows_by_hand():
    """400x2000, T = 3, halo 216,000 B: t_comm = 216,000 / 450e9 / 3 =
    0.16 us/step, the NVLink bytes alone (the copies are in t_shard)."""
    us = 1e-6
    t_shard = {1: 20 * us, 2: 11 * us, 4: 6 * us, 8: 0.1 * us}
    enqueue = {1: 5 * us, 2: 8 * us, 4: 14 * us, 8: 0.1 * us}
    rows = scaling.predict_rows(400, 2000, 1200, t_shard, enqueue, 3, 216_000)
    comm = 0.48 / 3 * us
    assert [r["chips"] for r in rows] == [1, 2, 4, 8]
    assert [r["rows"] for r in rows] == [400, 200, 100, 50]
    assert rows[0]["t_comm"] == 0.0 and rows[0]["t_pred"] == 20 * us
    assert rows[1]["t_comm"] == pytest.approx(comm, rel=1e-12)
    assert rows[1]["t_edges"] == pytest.approx(0.33 * us, rel=1e-12)  # 6 / 200 * 11
    assert rows[1]["t_pred"] == 11 * us and not rows[1]["host_bound"]
    # the host's enqueue sets the floor
    assert rows[2]["t_pred"] == 14 * us and rows[2]["host_bound"]
    # the exchange and the bands outlast the shard: 0.16 + 6 / 50 * 0.1
    assert rows[3]["t_pred"] == pytest.approx(comm + 0.012 * us, rel=1e-12)
    assert not rows[3]["host_bound"]
    assert rows[0]["mlups"] == pytest.approx(40_000, rel=1e-12)
    assert rows[0]["runtime_s"] == pytest.approx(0.024, rel=1e-12)
    assert rows[1]["speedup"] == pytest.approx(20 / 11, rel=1e-12)
    assert rows[1]["efficiency"] == pytest.approx(10 / 11, rel=1e-12)
    assert rows[2]["mlups"] == pytest.approx(800_000 / 14, rel=1e-12)
    assert rows[3]["efficiency"] == pytest.approx(20 / (comm / us + 0.012) / 8, rel=1e-12)


def test_predict_rows_sync_schedule():
    """The DP section: hi and lo halos, 1,152,000 B a pass, t_pred =
    t_shard + t_comm with t_comm = 1,152,000 / 450e9 / 4 = 0.64 us/step,
    no bands."""
    us = 1e-6
    t_shard = {1: 132 * us, 2: 70 * us}
    rows = scaling.predict_rows(800, 4000, 1000, t_shard, {1: 30 * us, 2: 40 * us},
                                4, 1_152_000, sync=True)
    comm = 2.56 / 4 * us
    assert rows[1]["t_edges"] == 0.0
    assert rows[1]["t_pred"] == pytest.approx(70 * us + comm, rel=1e-12)
    assert rows[1]["mlups"] == pytest.approx(3.2 / (70 + comm / us) * 1e6, rel=1e-12)


def test_device_modes_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = sharded.make_mesh(devices=["cpu"])
    for call in (lambda: scaling.mode_gpu(mesh), lambda: scaling.mode_ab(mesh),
                 scaling.mode_predict, lambda: scaling.main(["--mode", "gpu"])):
        with pytest.raises(RuntimeError, match="only --mode cpu runs on the CPU"):
            call()
