"""A copy of lbm_bench and BENCHMARK.json in a temporary directory, with
tiny cells beside the real ones that run on the CPU: the program's
`torch` backend stands in for `cuda`, the lattice is 32x64 (channel
walls and a 16x2 plate), a chunk is 8 steps and a run 3 chunks. Each
tiny cell keeps the limits of the real cell it shrinks. A float64 cell on the pair-DP
`torch-ds64` backend, whose state is a (hi, lo) pair, has limits of its
own (TINY_DS_LIMITS) and the program's float32 path as its control.
TINY_RUNS restarts the flow every two chunks."""

from __future__ import annotations

import json
import pathlib
import shutil
import time

from lbm_bench import harness, manifest

REAL = manifest.ROOT
# tiny cell -> (real cell whose limits it keeps, storage, probed)
TINY = {
    "tiny-f32.steady": ("ref800x4000-f32.steady", "float32", False),
    "tiny-f32.probed": ("ref800x4000-f32.probed", "float32", True),
    "tiny-bf16.steady": ("ref4000x16000-bf16.steady", "bfloat16", False),
}
TINY_DS = "tiny-ds64.steady"
TINY_RUNS = "tiny-f32.runs"
TINY_DS_LIMITS = {"start_err": 0, "state_err": 1e-9, "re_err": 1e-9}
WALLS = {"edges": True, "blocks": [[2, 18, 3, 5]]}
SEED = 2**31 + 4242


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    """A checkout-like root under tmp holding lbm_bench, BENCHMARK.json
    and the tiny cells."""
    root = tmp / "checkout"
    shutil.copytree(REAL / "lbm_bench", root / "lbm_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = json.loads((REAL / "BENCHMARK.json").read_text())
    bench = root / "lbm_bench"
    base = json.loads((bench / "configs" / "ref-800x4000-f32.json").read_text())
    bf16 = json.loads((bench / "configs" / "ref-4000x16000-bf16.json").read_text())
    ds = dict(base, dtype="float64", arithmetic="float64", backend="torch-ds64",
              control={"by": "program", "dtype": "float32", "backend": "torch"})
    for name, cfg in (("tiny-f32", base), ("tiny-bf16", bf16), ("tiny-ds64", ds)):
        cfg = dict(cfg, nx=32, ny=64, walls=WALLS, backend=cfg["backend"].replace("cuda", "torch"))
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        m["configs"].append({"name": name, "source": "a test", "file": f"lbm_bench/configs/{name}.json",
                             "reduced": [], "why": "a test"})
    for probed in (False, True):
        traffic = {"steps_per_chunk": 8, "probes": None, "check_chunk_below": 3,
                   "trace_chunks": 2, "steps_per_run": 24}
        if probed:
            traffic["probes"] = {"count": 4, "every": 2, "rows": [2, 10], "cols": [10, 30]}
        (bench / "traffic" / f"tiny-{'probed' if probed else 'steady'}.json").write_text(
            json.dumps(traffic))
    (bench / "traffic" / "tiny-runs.json").write_text(json.dumps(
        {"steps_per_chunk": 8, "check_chunk_below": 2, "trace_chunks": 2, "steps_per_run": 16}))
    for name, (real, dtype, probed) in TINY.items():
        m["workloads"].append({"name": name, "config": name.split(".")[0],
                               "traffic": f"tiny-{'probed' if probed else 'steady'}",
                               "chips": 1, "why": "a test"})
        shutil.copy(bench / "limits" / f"{real}.json", bench / "limits" / f"{name}.json")
        for metric in m["per_layer"]:
            if real in metric["workloads"]:
                metric["workloads"].append(name)
    m["workloads"].append({"name": TINY_DS, "config": "tiny-ds64", "traffic": "tiny-steady",
                           "chips": 1, "why": "a test"})
    m["workloads"].append({"name": TINY_RUNS, "config": "tiny-f32", "traffic": "tiny-runs",
                           "chips": 1, "why": "a test"})
    shutil.copy(bench / "limits" / "ref800x4000-f32.steady.json",
                bench / "limits" / f"{TINY_RUNS}.json")
    for metric in m["per_layer"]:
        if "ref800x4000-f32.steady" in metric["workloads"]:
            metric["workloads"].append(TINY_RUNS)
    (bench / "limits" / f"{TINY_DS}.json").write_text(json.dumps(TINY_DS_LIMITS))
    (root / "BENCHMARK.json").write_text(json.dumps(m, indent=1))
    return root


def limits_of(name: str) -> dict:
    """The limits a tiny cell keeps: its real cell's, or the ds cell's."""
    if name == TINY_DS:
        return TINY_DS_LIMITS
    return json.loads((REAL / "lbm_bench" / "limits" / f"{TINY[name][0]}.json").read_text())


def run(root, name: str, *, seconds: float = 0.3, traced: bool = False, seed: int = SEED,
        **kwargs) -> dict:
    return harness.run_cell(manifest.cell(name, root), seed, seconds, traced,
                            time.perf_counter(), device="cpu", emit=lambda s: None, **kwargs)
