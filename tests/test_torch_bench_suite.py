"""The port's benchmark suite (latticeboltzmann_tpu_torch/bench_suite.py),
the flags of its bench.py, and its two accuracy scripts
(scripts/validate_ds.py, scripts/numerics_tiers.py) on the CPU: the
rows against the JAX package's CONFIGS, one tiny row through run_config
on the plain engine, the table writer, the scripts at a tiny size on the
plain backends, and the refusals without a card."""

import json

import numpy as np
import pytest
import torch

from latticeboltzmann_tpu.bench_suite import CONFIGS as JAX_CONFIGS
from latticeboltzmann_tpu_torch import bench, bench_suite
from latticeboltzmann_tpu_torch.ops.fused_ds_kernel import BYTES_PER_SITE_DS
from latticeboltzmann_tpu_torch.scripts import numerics_tiers, validate_ds

torch.set_num_threads(1)


def test_bench_suite_configs_integrity():
    """tests/test_utils.py:263 on the port's rows: 13 rows, every
    precision, the sharded, ds64 and sharded ds64 kernel rows, the
    cylinder, sane shapes."""
    configs = bench_suite.CONFIGS
    assert len(configs) == 13
    assert {c[3] for c in configs} == {"f64", "f32", "bf16", "ds64"}
    assert any(c[5] == "sharded-cuda" for c in configs)
    assert any(c[5] == "cuda-ds64" for c in configs)
    assert any(c[5] == "sharded-cuda-ds64" for c in configs)
    assert any(c[4] == "cylinder" for c in configs)
    for name, nx, ny, prec, geo, backend, rt, hw in configs:
        assert nx % 8 == 0 and ny >= 128
        assert (backend == "torch") == (prec == "f64")


def test_rows_are_the_jax_rows_under_the_backend_map():
    """Row by row: the JAX suite's name, size, precision, geometry and
    published baseline, its backend under the port's name."""
    assert len(bench_suite.CONFIGS) == len(JAX_CONFIGS)
    for ours, theirs in zip(bench_suite.CONFIGS, JAX_CONFIGS):
        assert ours[5] == bench_suite.BACKEND_NAMES[theirs[5]]
        assert ours[:5] + ours[6:] == theirs[:5] + theirs[6:]


def test_a_tiny_row_on_the_plain_engine(capsys):
    """Row 1 (float64 on "torch") at 16x40 on the CPU through run_rows and
    run_config: every timing key, sane, the card's line and the baseline
    carried."""
    (name, _, _, prec, geo, backend, rt, hw) = bench_suite.CONFIGS[0]
    rows = bench_suite.run_rows([(name, 16, 40, prec, geo, backend, rt, hw)], 24, "a card",
                                device="cpu")
    (row,) = rows
    assert json.loads(capsys.readouterr().out) == row
    assert row["sane"] and row["backend"] == "torch" and row["lattice"] == "16x40"
    assert row["steps"] == 24 and len(row["e2e_runs_s"]) >= bench_suite.E2E_RUNS
    assert row["runtime_s"] == min(row["e2e_runs_s"])
    for key in ("mlups", "slope_mlups", "slope_us_per_step", "slope_valid",
                "degraded_environment", "reynolds", "wall_total_s"):
        assert key in row
    assert row["card"] == "a card" and row["baseline_hw"] == hw
    assert row["baseline_mlups"] == pytest.approx(16 * 40 * 10000 / rt / 1e6)
    assert bench_suite.row_steps("f64", 10000) == bench_suite.F64_MAX_STEPS
    assert bench_suite.row_steps("f32", 10000) == 10000


def test_write_table_and_append(tmp_path):
    """--out writes the table and the jsonl beside it; --append keeps the
    jsonl's rows of other configs, in CONFIGS order."""
    def row(k, mlups):
        return {"config": bench_suite.CONFIGS[k][0], "backend": bench_suite.CONFIGS[k][5],
                "steps": 10, "runtime_s": 1.0, "mlups": mlups, "slope_mlups": mlups,
                "sane": True}

    out = tmp_path / "t.md"
    bench_suite.write_table(str(out), [row(2, 3.0)], 10, "card", append=False)
    bench_suite.write_table(str(out), [row(0, 1.0)], 10, "card", append=True)
    rows = [json.loads(line) for line in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert [r["config"] for r in rows] == [bench_suite.CONFIGS[0][0], bench_suite.CONFIGS[2][0]]
    table = out.read_text()
    assert "| 400x2000 f64 (serial C workload) | torch | 10 |" in table and "Card: card" in table


def test_entry_points_refuse_without_a_card(tmp_path, capsys):
    """bench, bench_suite, validate_ds and numerics_tiers exit 2 without a
    card unless the CPU is asked for; bench_suite never writes the JAX
    package's BENCH_RESULTS files."""
    for name in ("BENCH_RESULTS.md", "BENCH_RESULTS.jsonl", "BENCH_RESULTS.txt", "BENCH_RESULTS"):
        # the table's .jsonl companion would be BENCH_RESULTS.jsonl
        assert bench_suite.main(["--out", str(tmp_path / name), "--quick"]) == 2
    assert list(tmp_path.iterdir()) == []
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert bench.main([]) == 2
    assert bench_suite.main(["--quick"]) == 2
    assert validate_ds.main([]) == 2
    assert numerics_tiers.main([]) == 2
    assert "no CUDA card" in capsys.readouterr().err


def test_bench_parses_the_suite_flags(capsys):
    """bench.py's flags for the suite's rows: --geometry, --precision f64,
    --skew/--no-skew, --temporal; the precision's backend and bytes.
    --temporal selects passes of T steps on the cuda backend in f32 and
    bf16 ("auto" takes cuda there on a card), so it passes the flag check
    there; on torch, f64, ds64 and the sharded backends it would select
    nothing, and --skew/--no-skew select nothing anywhere: bench refuses
    those before it looks for a card, and records no setting that did not
    run."""
    parse = bench.build_parser().parse_args
    args = parse(["--geometry", "cylinder", "--precision", "f64", "--no-skew", "--temporal", "4"])
    assert (args.geometry, args.precision, args.skew, args.temporal) == ("cylinder", "f64",
                                                                        False, 4)
    args = parse(["--skew"])
    assert args.skew is True and args.temporal is None and args.geometry == "reference"
    assert parse([]).skew is None
    for flags in (["--skew"], ["--no-skew"], ["--temporal", "4", "--precision", "f64"],
                  ["--temporal", "4", "--precision", "ds64"],
                  ["--temporal", "4", "--precision", "ds64", "--backend", "sharded-cuda-ds64"],
                  ["--temporal", "4", "--backend", "sharded-cuda"],
                  ["--temporal", "4", "--backend", "sharded-cuda-rdma"],
                  ["--temporal", "4", "--backend", "torch"],
                  ["--temporal", "0", "--backend", "cuda"],
                  ["--skew", "--temporal", "4", "--backend", "cuda"]):
        assert bench.schedule_refusal(parse(flags)) is not None, flags
        assert bench.main(flags) == 2, flags
        err = capsys.readouterr().err
        assert "select" in err or "at least one step" in err, err
        assert "no CUDA card" not in err  # refused before the card check
    for flags in (["--temporal", "4", "--backend", "cuda"], ["--temporal", "2"],
                  ["--temporal", "8", "--precision", "bf16"], ["--backend", "cuda"], []):
        assert bench.schedule_refusal(parse(flags)) is None, flags
    if not torch.cuda.is_available():
        assert bench.main(["--temporal", "4", "--backend", "cuda"]) == 2
        assert "no CUDA card" in capsys.readouterr().err
    assert bench.precision_setup("f64", "auto") == (np.float64, "torch", 144)
    assert bench.precision_setup("ds64", "auto") == (np.float64, "cuda-ds64", BYTES_PER_SITE_DS)
    assert bench.precision_setup("ds64", "sharded-cuda-ds64")[1] == "sharded-cuda-ds64"
    assert bench.precision_setup("bf16", "cuda") == ("bfloat16", "cuda", 36)
    with pytest.raises(SystemExit):
        bench.build_parser().parse_args(["--precision", "f16"])


def test_validate_ds_at_a_tiny_size(capsys):
    """scripts/validate_ds.py on torch-ds64 at 16x40 on the CPU, 40 steps
    (the flow has reached the central column by then; at 20 steps Re is
    about 1e-5, a cancellation): Re within 1e-9 of the float64 engine, one
    JSON line, exit 0."""
    assert validate_ds.main(["--nx", "16", "--ny", "40", "--steps", "40",
                             "--backend", "torch-ds64", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["reynolds_pass"] and out["reynolds_rel_err"] <= validate_ds.RE_RTOL
    assert out["state_max_rel_err"] < 1e-12 and abs(out["mass_drift_ds"]) < 1e-12
    assert "card" not in out


def test_numerics_tiers_at_a_tiny_size(capsys):
    """scripts/numerics_tiers.py at 16x40 on the CPU (torch, torch-ds64):
    every tier against the float64 anchor, the wake statistics from
    run_probed(every=4) at the scaled probes, exit 0."""
    assert numerics_tiers.main(["--nx", "16", "--ny", "40", "--steps", "40",
                                "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["probes"] == [[1, 2], [2, 3], [3, 4]]
    tiers = out["tiers"]
    assert set(tiers) == {"f32", "bf16", "ds64", "f64"}
    assert tiers["f64"]["state_rel_err_8"] == 0.0
    assert tiers["ds64"]["state_rel_err_8"] < 1e-12
    assert tiers["f32"]["state_rel_err_8"] < 1e-5 < tiers["bf16"]["state_rel_err_8"]
    for t in tiers.values():
        assert len(t["wake_u2_mean"]) == len(t["wake_u2_std"]) == 3
        assert np.isfinite(t["mass_drift_rel_40"])
    np.testing.assert_allclose(tiers["ds64"]["wake_u2_mean"], tiers["f64"]["wake_u2_mean"],
                               rtol=1e-10)
    with pytest.raises(ValueError, match="multiple of"):
        numerics_tiers.measure(16, 40, 42, "cpu")
