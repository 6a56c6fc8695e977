"""The generator: what a seed makes, the traffic files, and the closed
loop of each mix at a tiny size on the CPU `torch` backend."""

import json

import numpy as np
import pytest
import torch

import lbm_bench_tiny as tiny
from lbm_bench import check, generator, manifest
from lbm_bench.reference import d2q9

P = d2q9.Params()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("traffic"))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**33 + 5])
def test_a_seed_makes_the_same_inputs_and_another_seed_others(seed):
    a = generator.initial_state(32, 64, P, torch.float32, seed, "cpu")
    b = generator.initial_state(32, 64, P, torch.float32, seed, "cpu")
    c = generator.initial_state(32, 64, P, torch.float32, seed + 1, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    rho = a.sum(0)
    # a rest state of smooth bumps about the initial density: no operation fails on it
    assert torch.all(a > 0)
    assert float((rho / P.initial_density - 1).abs().max()) <= generator.BUMP_HEIGHT * generator.BUMPS
    u_y = (a[5] + a[1] + a[8] - a[6] - a[3] - a[7]) / rho
    assert float(u_y.abs().max()) < 1e-6


def test_bf16_inputs_are_the_f32_inputs_rounded():
    a = generator.initial_state(32, 64, P, torch.float32, 3, "cpu")
    b = generator.initial_state(32, 64, P, torch.bfloat16, 3, "cpu")
    assert torch.equal(a.to(torch.bfloat16), b)


def test_probe_sites_and_the_checked_chunk_come_from_the_seed():
    t = generator.Traffic.load(manifest.ROOT / "lbm_bench" / "traffic" / "stats-1000-probes-100.json")
    s = generator.probe_sites(t, 2**31 + 1)
    assert s.shape == (3, 2) and s.dtype == np.int64
    assert len({tuple(x) for x in s}) == 3
    assert (s[:, 0] >= 20).all() and (s[:, 0] < 220).all()
    assert (s[:, 1] >= 110).all() and (s[:, 1] < 600).all()
    assert np.array_equal(s, generator.probe_sites(t, 2**31 + 1))
    ks = {generator.checked_chunk(t, seed) for seed in range(200)}
    assert ks == set(range(t.check_chunk_below))
    steady = generator.Traffic.load(manifest.ROOT / "lbm_bench" / "traffic" / "stats-1000.json")
    assert generator.probe_sites(steady, 1) is None and steady.samples_per_chunk == 0


@pytest.mark.parametrize("spec, what", [
    ({"steps_per_chunk": 8, "colour": 1}, "unknown"),
    ({"steps_per_chunk": 0}, "steps_per_chunk"),
    ({"steps_per_chunk": 8, "probes": {"count": 1, "every": 3, "rows": [0, 1], "cols": [0, 1]}},
     "divide"),
    ({"steps_per_chunk": 8, "check_chunk_below": 0}, "check_chunk_below"),
])
def test_malformed_traffic_is_refused(tmp_path, spec, what):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(spec))
    with pytest.raises(ValueError, match=what):
        generator.Traffic.load(path)


def test_the_real_mixes_keep_the_cadences_users_run():
    """Re every 1000 steps (the upstream's PRINTSTATSEVERY and the CLI's
    --print-stats-every), probes every 100 (the CLI's --probe-every) at
    the 3 sites of the README's example."""
    for w in manifest.load()["workloads"]:
        t = generator.Traffic.load(manifest.cell(w["name"]).traffic_path)
        assert t.steps_per_chunk == 1000
        assert t.probes is None or (t.probes["every"], t.probes["count"]) == (100, 3)


@pytest.mark.parametrize("name", sorted(tiny.TINY) + [tiny.TINY_DS])
def test_the_loop_runs_and_checks_on_the_cpu(root, name):
    r = tiny.run(root, name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    m = r["metrics"]
    assert set(m) == {"mlups", "chunk_ms_p95", "peak_mem_gib", "setup_s"}
    assert m["mlups"]["value"] > 0 and m["chunk_ms_p95"]["value"] > 0
    assert set(r["checks"]) == set(manifest.cell(name, root).limits)
    assert set(r["readings"]) == set(check.NUMBERS) - (
        set() if tiny.TINY.get(name, (None, None, False))[2] else {"probe_err"})
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


def test_the_percentile_is_over_every_value():
    assert generator.percentile(list(range(101)), 95) == 95
    assert generator.percentile([1.0, 2.0], 50) == 1.5
