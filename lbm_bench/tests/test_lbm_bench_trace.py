"""The per-layer readers on a written trace: two chunks of a probed mix
at 800x4000 f32, marks, step kernels, gather kernels and a copy."""

import pytest

from lbm_bench import generator, harness, manifest, roofline, trace

STEP = "void (anonymous namespace)::lbm_stream_collide_wide<float, 2, 4>(float const*, float*)"
GATHER = "void at::native::index_elementwise_kernel<128, 4>(int, at::native::foo)"


def written_trace():
    """Chunk c (c = 0, 1) starts at 1000 c us: marks at +0, +600, +700;
    4 step launches of 100 us on the card from +10; 2 gather kernels of
    5 us; the readback's copy of 20 us."""
    ev, corr = [], [0]

    def x(cat, name, ts, dur, c=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1}
        if c is not None:
            e["args"] = {"correlation": c}
        ev.append(e)

    def launch(host_ts, name, dev_ts, dur, cat="kernel"):
        corr[0] += 1
        x("cuda_runtime", "cudaLaunchKernel", host_ts, 4, corr[0])
        x(cat, name, dev_ts, dur, corr[0])

    for c in range(2):
        t = 1000 * c
        for m in (0, 600, 700):
            x("cuda_runtime", trace.MARK_CALL, t + m, 1)
        for i in range(4):
            launch(t + 2 + 20 * i, STEP, t + 10 + 100 * i, 100)
        launch(t + 100, GATHER, t + 410, 5)
        launch(t + 110, GATHER, t + 415, 5)
        corr[0] += 1
        x("cuda_runtime", "cudaMemcpyAsync", t + 620, 30, corr[0])
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", t + 630, 20, corr[0])
    return {"traceEvents": ev}


@pytest.fixture
def ctx():
    cell = manifest.cell("ref800x4000-f32.probed")
    traffic = generator.Traffic.load(cell.traffic_path)
    view = trace.TraceView(trace.events_of(written_trace()))
    chunks = [generator.Chunk(0.0, 0.0006, 0.0007, 0.0)] * 4
    return harness.Context(cell=cell, traffic=traffic, chunks=chunks, window_s=0.0028,
                           setup_s=9.0, peak_bytes=2**30, traced=[2, 3], untraced=[0, 1],
                           view=view, plane=False)


def read(name, ctx):
    return manifest.reader(name)(ctx)


def test_marks_make_the_spans(ctx):
    v = ctx.view
    assert v.steps == [(1, 600), (1001, 1600)]
    assert v.readback == [(601, 700), (1601, 1700)]
    assert (v.start, v.end) == (1, 1700) and v.window_us == 1699
    assert v.busy_us() == 2 * (400 + 10 + 20)


def test_the_readers(ctx):
    steps = 2 * ctx.traffic.steps_per_chunk
    assert read("kernel_us_per_step", ctx) == pytest.approx(800 / steps)
    samples = 2 * ctx.traffic.samples_per_chunk
    assert read("gather_us_per_sample", ctx) == pytest.approx(20 / samples)
    assert read("gather_launches_per_sample", ctx) == pytest.approx(4 / samples)
    # the last launch call of each chunk ends at +114
    assert read("enqueue_us_per_step", ctx) == pytest.approx((114 - 1) / ctx.traffic.steps_per_chunk)
    assert read("device_idle", ctx) == pytest.approx(100 * (1 - 860 / 1699))
    assert read("readback_us", ctx) == pytest.approx(100)
    least = 8 * roofline.least_time_s(800, 4000, "float32", steps / 8)
    assert read("kernel_roofline", ctx) == pytest.approx(100 * least / 800e-6)


def test_the_end_to_end_readers(ctx):
    e2e = lambda name: manifest.reader(name, kind="end_to_end")(ctx)
    assert e2e("mlups") == pytest.approx(4 * ctx.traffic.steps_per_chunk * 800 * 4000 / 0.0028 / 1e6)
    assert e2e("chunk_ms_p95") == pytest.approx(0.7)
    assert e2e("peak_mem_gib") == 1.0 and e2e("setup_s") == 9.0


def test_a_trace_without_marks_gives_nothing(ctx):
    events = [e for e in trace.events_of(written_trace()) if e.name != trace.MARK_CALL]
    ctx.view = trace.TraceView(events)
    for name in ("kernel_us_per_step", "kernel_roofline", "device_idle", "enqueue_us_per_step",
                 "gather_us_per_sample"):
        assert read(name, ctx) is None, name
    ctx.view = None
    assert read("kernel_roofline", ctx) is None


def test_the_breakdown(ctx):
    b = ctx.view.breakdown()
    assert b["device_ops"][0] == ["lbm_stream_collide_wide", pytest.approx(800e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert sum(s for _, s in b["idle_gaps"]) <= (1699 - 860) * 1e-6 + 1e-12
    assert all(name.split(":")[0] in ("steps", "readback", "between chunks")
               for name, _ in b["idle_gaps"])


def test_kernel_function():
    assert trace.kernel_function(STEP) == "lbm_stream_collide_wide"
    assert trace.kernel_function("void lbm_temporal_steps<float, 2>(float const*)") \
        == "lbm_temporal_steps"
    assert trace.kernel_function("") == ""
