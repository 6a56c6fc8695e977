"""The CLI's backend and device choice, and the pair-DP path through the
CLI. Two faults of the port against the JAX package are pinned here:

- `--precision f64` with `--backend auto` on a card resolved to the
  float32-only kernel backend and raised; the JAX CLI resolves auto to
  its plain engine's route for float64 (latticeboltzmann_tpu/cli.py:90-99
  and the planner's float64 route), so the port now picks "torch".
- the "torch" backends ran on the CPU even with a card present; JAX's
  "xla" runs on its default device, the accelerator.

The card is monkeypatched: no CUDA tensor is allocated.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, available_backends, geometry
from latticeboltzmann_tpu_torch.cli import build_parser, resolve_backend
from latticeboltzmann_tpu_torch.models.engine import default_device

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("card", [True, False])
def test_auto_backend_follows_precision_and_card(card, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    assert resolve_backend("auto", np.float32) == ("cuda" if card else "torch")
    assert resolve_backend("auto", np.float64) == "torch"
    # an explicit choice is never rerouted: cuda with f64 still raises in
    # Simulation (the kernel takes float32 only)
    assert resolve_backend("cuda", np.float64) == "cuda"
    assert resolve_backend("cuda-ds64", np.float64) == "cuda-ds64"


@pytest.mark.parametrize("card", [True, False])
def test_default_device_follows_the_card(card, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    for backend in ("torch", "torch-ds64"):
        assert default_device(backend) == ("cuda" if card else "cpu")
    for backend in ("cuda", "cuda-ds64"):
        assert default_device(backend) == "cuda"


def test_explicit_device_wins(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float64)
    for backend in ("torch", "torch-ds64"):
        sim = Simulation(cfg, geometry.empty(16, 40), backend=backend, device="cpu")
        assert sim.device.type == "cpu"


def test_cli_ds64_end_to_end():
    proc = subprocess.run(
        [sys.executable, "-m", "latticeboltzmann_tpu_torch", "--nx", "16", "--ny", "40",
         "--steps", "20", "--backend", "torch-ds64", "--precision", "f64",
         "--print-stats-every", "10", "--warmup", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("Lattice Size: 16x40")
    assert "backend=torch-ds64 precision=f64 device=cpu" in lines[0]
    re_printed = float(lines[-2].split(" Re ")[1])
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float64)
    sim = Simulation(cfg, geometry.build("barrier", 16, 40), backend="torch-ds64").run(20)
    assert re_printed == pytest.approx(sim.reynolds(), rel=1e-9)


def test_cli_backend_help_covers_registry():
    """The --backend help names every registered backend, as
    tests/test_core.py:95-105 pins for the JAX CLI."""
    helptext = next(a.help for a in build_parser()._actions
                    if "--backend" in getattr(a, "option_strings", ()))
    missing = [b for b in available_backends() if b not in helptext]
    assert not missing, f"--backend help omits {missing}"
    assert "sharded-cuda-rdma" in available_backends()


@pytest.mark.parametrize("argv,want", [([], None), (["--skew"], True), (["--no-skew"], False)])
def test_cli_skew_flags_parse(argv, want):
    """--skew / --no-skew as the JAX CLI (latticeboltzmann_tpu/cli.py:73-79):
    None unless given."""
    assert build_parser().parse_args(argv).skew is want


def test_cli_skew_runs_and_changes_nothing():
    outs = []
    for flag in ("--skew", "--no-skew"):
        proc = subprocess.run(
            [sys.executable, "-m", "latticeboltzmann_tpu_torch", "--nx", "16", "--ny", "40",
             "--steps", "60", "--backend", "torch", "--print-stats-every", "0", "--warmup", "0",
             flag],
            cwd=REPO, capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stderr
        outs.append([line.split(" Re ")[1] for line in proc.stdout.splitlines() if " Re " in line])
    assert len(outs[0]) == 1 and outs[0] == outs[1]


def test_cli_opts_in_to_an_experimental_backend_named_outright(monkeypatch):
    """`--backend sharded-cuda-rdma` on the command line is the opt-in; it
    then asks for its card like every kernel backend, and `auto` never
    resolves to it."""
    from latticeboltzmann_tpu_torch import cli

    seen = {}

    class Recorder:
        def __init__(self, cfg, walls, **kw):
            seen.update(kw)
            raise SystemExit(0)

    monkeypatch.setattr("latticeboltzmann_tpu_torch.models.engine.Simulation", Recorder)
    for backend, opted in (("sharded-cuda-rdma", True), ("auto", False)):
        with pytest.raises(SystemExit):
            cli.main(["--nx", "16", "--ny", "40", "--backend", backend])
        assert seen["allow_experimental"] is opted and seen["skew"] is None
        assert seen["backend"] == (backend if opted else resolve_backend("auto", np.float32))
