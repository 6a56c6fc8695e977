"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, the files each entry names, and the check's limits."""

import json
import re

import pytest

from lbm_bench import check, generator, manifest

M = manifest.load()
ROOT = manifest.ROOT
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
FILE_CHARS = re.compile(r"[A-Za-z0-9_.\-/]+")


def line_of_text(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(M) == TOP
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert M["command"] == ["python3", "-m", "lbm_bench.run"]
    assert all(line_of_text(w) for w in M["command"]) and len(M["command"]) <= 32
    assert M["paths"] == ["lbm_bench"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_valid(kind):
    names = [x["name"] for x in M[kind]]
    assert len(set(names)) == len(names)
    assert all(manifest.valid_name(n) for n in names)


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert line_of_text(c["source"]) and line_of_text(c["why"])
        assert c["file"].startswith("lbm_bench/") and FILE_CHARS.fullmatch(c["file"])
        assert len(c["reduced"]) <= 16 and all(manifest.valid_name(k) for k in c["reduced"])
        spec = json.loads((ROOT / c["file"]).read_text())
        assert "temporal" not in spec, "a configuration runs the program's default depth"
        assert spec["reduced"] == c["reduced"]
        manifest.Config.load(c["name"], ROOT / c["file"])


def test_workloads():
    assert 1 <= len(M["workloads"]) <= 24
    configs = {c["name"] for c in M["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert manifest.valid_name(w["traffic"]) and line_of_text(w["why"])
        generator.Traffic.load(ROOT / "lbm_bench" / "traffic" / f"{w['traffic']}.json")


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    e2e = {m["name"] for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    for m in M[kind]:
        extra = {"bound"} if kind == "end_to_end" else {"layer", "moves"}
        assert set(m) - {"workloads"} == METRIC_KEYS | extra
        assert manifest.valid_unit(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in SOURCES and line_of_text(m["layer"])
            assert m["moves"] in e2e
        folder = "end_to_end" if kind == "end_to_end" else "layer_metrics"
        assert (ROOT / "lbm_bench" / folder / f"{m['name']}.py").is_file()
    if kind == "end_to_end":
        assert "setup_s" in e2e and 2 <= len(M["end_to_end"]) <= 16
    else:
        assert 1 <= len(M["per_layer"]) <= 128


def test_every_cell_reports_what_the_contract_asks():
    for w in M["workloads"]:
        cell = manifest.cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_each_cell_has_a_limit_for_each_number_it_compares():
    for w in M["workloads"]:
        cell = manifest.cell(w["name"])
        probed = generator.Traffic.load(cell.traffic_path).probes is not None
        assert "start_err" in cell.limits and set(cell.limits) <= set(check.NUMBERS)
        assert ("probe_err" in cell.limits) == probed
        # the start is compared exactly; every other number has room above its lower reading
        assert cell.limits["start_err"] == 0
        assert all(v > 0 for name, v in cell.limits.items() if name != "start_err")


def test_files_under_paths_are_named_from_name_characters():
    for path in (ROOT / "lbm_bench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert FILE_CHARS.fullmatch(rel), rel
