"""The port's perf_plot (latticeboltzmann_tpu_torch/scripts/perf_plot.py):
a PNG from a two-row jsonl of the port suite's rows, the card label taken
from the rows, and its refusals (the JAX package's record; no
matplotlib). The plot itself needs matplotlib and skips without it."""

import json
import sys

import pytest

from latticeboltzmann_tpu_torch.scripts import perf_plot

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _rows(card=CARD):
    base = {"precision": "f32", "backend": "cuda", "steps": 1000, "sane": True}
    rows = [dict(base, config="a", lattice="400x4000", mlups=35343.5, baseline_mlups=2136.2),
            dict(base, config="b", lattice="4000x16000", mlups=40603.5)]
    return [dict(r, card=card) if card else r for r in rows]


def _jsonl(path, rows):
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return path


def test_plot_writes_a_png(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    out = tmp_path / "img" / "perf.png"
    rc = perf_plot.main([str(_jsonl(tmp_path / "BENCH_RESULTS_TORCH.jsonl", _rows())),
                         "-o", str(out)])
    assert rc == 0 and f"wrote {out}" in capsys.readouterr().out
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_card_label_comes_from_the_rows(monkeypatch):
    assert perf_plot.card_label(_rows()) == CARD
    monkeypatch.setattr("latticeboltzmann_tpu_torch.bench.card_info", lambda: "a card, 1 W")
    assert perf_plot.card_label(_rows(card=None)) == "a card, 1 W"


@pytest.mark.parametrize("case", ["jax-record", "no-matplotlib"])
def test_refusals_exit_2(tmp_path, capsys, monkeypatch, case):
    name = "BENCH_RESULTS.jsonl" if case == "jax-record" else "rows.jsonl"
    path = _jsonl(tmp_path / name, _rows())
    if case == "no-matplotlib":
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "perf.png"
    assert perf_plot.main([str(path), "-o", str(out)]) == 2
    err = capsys.readouterr().err
    assert ("JAX package's record" if case == "jax-record" else "needs matplotlib") in err
    assert not out.exists()
