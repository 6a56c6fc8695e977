"""Benchmark plot of the port: twin of the JAX package's
scripts/perf_plot.py (the counterpart of the reference's gnuplot
scripts, perfplot.plt and perfplot-mpi.plt). Draws the rows of the port's
suite (bench_suite.py --out BENCH_RESULTS_TORCH.md writes them beside the
table as BENCH_RESULTS_TORCH.jsonl) as an MLUPS bar chart beside the
reference's published baselines, the bars labelled with the card the
rows name (their "card": nvidia-smi's name and power limit), or with
bench.card_info() where a row names none.

It refuses the JAX package's BENCH_RESULTS.jsonl, that package's record
(as bench_suite.py refuses to write it), and needs matplotlib: where
matplotlib does not import it says so and exits 2.

Usage: python -m latticeboltzmann_tpu_torch.scripts.perf_plot
           [BENCH_RESULTS_TORCH.jsonl] [-o img/perf_torch.png]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from ..bench_suite import JAX_RECORDS


def card_label(rows: list[dict]) -> str:
    """The card the rows ran on: their "card" values, else
    bench.card_info()."""
    cards = sorted({r["card"] for r in rows if r.get("card")})
    if cards:
        return "; ".join(cards)
    from ..bench import card_info

    return card_info()


def plot(rows: list[dict], out, card: str) -> pathlib.Path:
    """The bar chart of `rows` (bench_suite's row dicts) at `out`, PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = [f'{r["lattice"]}\n{r["precision"]} {r["backend"]}' for r in rows]
    ours = [r["mlups"] for r in rows]
    base = [r.get("baseline_mlups") for r in rows]
    x = range(len(rows))
    fig, ax = plt.subplots(figsize=(1.8 * len(rows) + 2, 4.5))
    ax.bar([i - 0.2 for i in x], ours, width=0.4, label=f"the port ({card})")
    ax.bar([i + 0.2 for i, b in zip(x, base) if b], [b for b in base if b], width=0.4,
           label="reference baseline (best published)")
    ax.set_xticks(list(x))
    ax.set_xticklabels(labels, fontsize=8)
    ax.set_ylabel("MLUPS (million lattice updates / s)")
    ax.set_title("D2Q9 LBM throughput vs jodavies/latticeboltzmann baselines")
    ax.legend()
    ax.grid(axis="y", alpha=0.3)
    for i, v in zip(x, ours):
        ax.annotate(f"{v:,.0f}", (i - 0.2, v), ha="center", va="bottom", fontsize=8)
    out = pathlib.Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="latticeboltzmann_tpu_torch.scripts.perf_plot")
    ap.add_argument("results", nargs="?", default="BENCH_RESULTS_TORCH.jsonl")
    ap.add_argument("-o", "--out", default="img/perf_torch.png")
    args = ap.parse_args(argv)
    path = pathlib.Path(args.results)
    if path.name in JAX_RECORDS:
        print(f"perf_plot: {path} is the JAX package's record; give the port suite's jsonl "
              "(bench_suite.py --out BENCH_RESULTS_TORCH.md writes BENCH_RESULTS_TORCH.jsonl)",
              file=sys.stderr)
        return 2
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        print(f"perf_plot: needs matplotlib, which does not import here ({e})", file=sys.stderr)
        return 2
    rows = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    out = plot(rows, args.out, card_label(rows))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
