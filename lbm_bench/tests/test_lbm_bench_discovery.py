"""The harness finds a configuration, a traffic mix, an end-to-end and a
per-layer metric and a cell's limits by the names BENCHMARK.json gives
them: a later PR adds files and entries and edits no file that is
there."""

import json
import pathlib

import pytest

import lbm_bench_tiny as tiny
from lbm_bench import manifest


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(tmp_path)


def test_each_name_finds_its_file():
    for w in manifest.load()["workloads"]:
        cell = manifest.cell(w["name"])
        assert cell.config.name == w["config"] and cell.traffic_path.is_file()
        for m in cell.per_layer:
            assert callable(manifest.reader(m["name"]))


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        manifest.cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        manifest.reader("no_such_metric")


def test_files_dropped_into_a_copy_are_found_with_no_other_edit(root: pathlib.Path):
    before = {p: p.read_bytes() for p in (root / "lbm_bench").rglob("*") if p.is_file()}
    bench = root / "lbm_bench"
    cfg = json.loads((bench / "configs" / "tiny-f32.json").read_text())
    (bench / "configs" / "wide-f32.json").write_text(json.dumps(dict(cfg, ny=96)))
    (bench / "traffic" / "steady-4.json").write_text(json.dumps(
        {"steps_per_chunk": 4, "check_chunk_below": 2, "trace_chunks": 2}))
    (bench / "layer_metrics" / "chunks_per_run.py").write_text(
        "def read(ctx):\n    return float(len(ctx.chunks))\n")
    (bench / "end_to_end" / "chunks_per_s.py").write_text(
        "def read(ctx):\n    return len(ctx.chunks) / ctx.window_s\n")
    (bench / "limits" / "wide-f32.steady.json").write_text(
        (bench / "limits" / "tiny-f32.steady.json").read_text())
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "wide-f32", "source": "a test", "reduced": [], "why": "a test",
                         "file": "lbm_bench/configs/wide-f32.json"})
    m["workloads"].append({"name": "wide-f32.steady", "config": "wide-f32",
                           "traffic": "steady-4", "chips": 1, "why": "a test"})
    m["end_to_end"].append({"name": "chunks_per_s", "unit": "1/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["wide-f32.steady"]})
    m["per_layer"].append({"name": "chunks_per_run", "unit": "count", "better": "higher",
                           "source": "host_clock", "layer": "facade", "moves": "mlups",
                           "workloads": ["wide-f32.steady"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    r = tiny.run(root, "wide-f32.steady", traced=True)
    assert r["correct"]
    assert r["metrics"]["chunks_per_run"]["value"] == r["attempted"]
    r = tiny.run(root, "wide-f32.steady")
    assert set(r["metrics"]) == {"mlups", "chunk_ms_p95", "peak_mem_gib", "setup_s",
                                 "chunks_per_s"}
    assert r["metrics"]["chunks_per_s"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
