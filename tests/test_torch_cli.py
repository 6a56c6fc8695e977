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

from latticeboltzmann_tpu_torch import LatticeConfig, Simulation, geometry
from latticeboltzmann_tpu_torch.cli import resolve_backend
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
