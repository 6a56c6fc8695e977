"""BENCHMARK.json and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own under lbm_bench/, found by the
name BENCHMARK.json gives it:

    configs/<config>.json         (BENCHMARK.json's `file` of the config)
    traffic/<traffic>.json        (read by generator.Traffic)
    limits/<workload>.json        (the limits of the cell's check)
    end_to_end/<metric>.py        (a reader: read(ctx) -> number)
    layer_metrics/<metric>.py     (a reader: read(ctx) -> number | None)

so a later cell, mix or metric is new files and new entries, and no
edit of a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def valid_name(name) -> bool:
    return isinstance(name, str) and NAME.fullmatch(name) is not None


def valid_unit(unit) -> bool:
    return isinstance(unit, str) and UNIT.fullmatch(unit) is not None


def load(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass(frozen=True)
class Config:
    """A configuration file: the lattice, its storage (`dtype`) and
    arithmetic, its solid sites (reference/scene.py), the backend it
    runs on, the physical constants, its control (the configuration one
    precision lower: {"by": "program" | "reference", "dtype": storage,
    "arithmetic": ..., "backend": ...}, see control.py), and its
    provenance."""

    name: str
    nx: int
    ny: int
    dtype: str
    arithmetic: str
    walls: dict
    backend: str
    tau: float
    csq: float
    accel: float
    initial_density: float
    control: dict
    source: str
    assumed: list
    reduced: list

    @classmethod
    def load(cls, name: str, path: pathlib.Path) -> "Config":
        spec = json.loads(path.read_text())
        if "temporal" in spec:
            raise ValueError(f"{path}: a configuration runs the program's default depth; "
                             "it names no temporal")
        return cls(name=name, **spec)


@dataclasses.dataclass(frozen=True)
class Cell:
    workload: dict
    config: Config
    traffic_path: pathlib.Path
    limits: dict
    end_to_end: list
    per_layer: list
    root: pathlib.Path


def cell(name: str, root: pathlib.Path = ROOT, manifest: dict | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json, with its configuration, traffic
    file, limits and the metrics it reports; KeyError for an unknown
    name."""
    m = load(root) if manifest is None else manifest
    work = {w["name"]: w for w in m["workloads"]}[name]
    conf = {c["name"]: c for c in m["configs"]}[work["config"]]
    bench = root / "lbm_bench"
    metrics = lambda kind: [x for x in m[kind] if name in x.get("workloads", [name])]
    return Cell(
        workload=work,
        config=Config.load(conf["name"], root / conf["file"]),
        traffic_path=bench / "traffic" / f"{work['traffic']}.json",
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
        end_to_end=metrics("end_to_end"),
        per_layer=metrics("per_layer"),
        root=root,
    )


def reader(metric: str, root: pathlib.Path = ROOT, kind: str = "layer_metrics"):
    """The read(ctx) function of <kind>/<metric>.py under lbm_bench
    (kind: "layer_metrics" or "end_to_end")."""
    path = root / "lbm_bench" / kind / f"{metric}.py"
    module_name = f"lbm_bench_{kind}_" + re.sub(r"\W", "_", metric)
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
