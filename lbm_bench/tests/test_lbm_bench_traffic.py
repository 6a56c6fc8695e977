"""The generator: what a seed makes, the traffic files, and the closed
loop of each mix at a tiny size on the CPU `torch` backend, restarted
from the window's start state at every run."""

import json
import math
import time

import numpy as np
import pytest
import torch

import lbm_bench_tiny as tiny
from lbm_bench import check, generator, harness, manifest
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
    ({"steps_per_chunk": 8, "steps_per_run": 12}, "multiple"),
    ({"steps_per_chunk": 8, "steps_per_run": 0}, "multiple"),
    ({"steps_per_chunk": 8, "steps_per_run": -16}, "multiple"),
    ({"steps_per_chunk": 8, "steps_per_run": 16, "check_chunk_below": 3}, "fit"),
    ({"steps_per_chunk": 8, "steps_per_run": 16, "check_chunk_below": 2, "trace_chunks": 3}, "fit"),
])
def test_malformed_traffic_is_refused(tmp_path, spec, what):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(spec))
    with pytest.raises(ValueError, match=what):
        generator.Traffic.load(path)


def test_the_real_mixes_keep_the_cadences_users_run():
    """Re every 1000 steps (the upstream's PRINTSTATSEVERY and the CLI's
    --print-stats-every), probes every 100 (the CLI's --probe-every) at
    the 3 sites of the README's example, runs of 10,000 steps (the
    upstream's NTIMESTEPS and the CLI's --steps)."""
    for w in manifest.load()["workloads"]:
        t = generator.Traffic.load(manifest.cell(w["name"]).traffic_path)
        assert t.steps_per_chunk == 1000 and t.steps_per_run == 10000
        assert t.probes is None or (t.probes["every"], t.probes["count"]) == (100, 3)


def test_without_steps_per_run_the_window_is_one_run():
    t = generator.Traffic(steps_per_chunk=8)
    assert t.chunks_per_run is None
    assert [t.starts_run(i) for i in range(4)] == [True, False, False, False]
    t = generator.Traffic(steps_per_chunk=8, steps_per_run=16)
    assert [t.starts_run(i) for i in range(5)] == [True, False, True, False, True]


class Recorder:
    """The program, recording the state each chunk starts from and
    taking RELOAD_S longer to load a state."""

    RELOAD_S = 0.05

    def __init__(self, sim):
        self.sim, self.starts = sim, []

    def __getattr__(self, name):
        return getattr(self.sim, name)

    @property
    def f(self):
        return self.sim.f

    @f.setter
    def f(self, value):
        time.sleep(self.RELOAD_S)
        self.sim.f = value

    def run(self, n_steps, **kw):
        self.starts.append(self.sim.f.clone())
        self.sim.run(n_steps, **kw)
        return self


def recorded(root, name, **kw):
    made = []

    def program(*args):
        made.append(Recorder(harness.default_program(*args)))
        return made[0]

    r = tiny.run(root, name, program=program, **kw)
    return r, made[0].starts[1:]  # the first start is the warm-up chunk's


def test_every_run_starts_from_the_windows_start_state_and_its_reload_is_not_timed(root):
    r, starts = recorded(root, tiny.TINY_RUNS, seconds=1.0)
    assert r["correct"], r["checks"]
    n, w = r["attempted"], r["window"]
    assert n >= 3 and len(starts) == n
    seeded = generator.initial_state(32, 64, P, torch.float32, tiny.SEED, "cpu")
    assert torch.equal(starts[0], seeded)
    for i in range(1, n):
        # each run's first chunk starts from the window's start, exactly;
        # its second from where the first left the flow
        assert torch.equal(starts[i], starts[0]) == (i % 2 == 0), i
    assert w["runs"] == math.ceil(n / 2)
    reloads = w["runs"] - 1
    assert w["reload_s"] >= Recorder.RELOAD_S * reloads
    # the reloads are outside the window: it holds the chunks and the
    # loop between them, less than one reload
    assert w["chunks_s"] <= w["window_s"] < w["chunks_s"] + Recorder.RELOAD_S
    steps = n * 8
    assert r["metrics"]["mlups"]["value"] == pytest.approx(steps * 32 * 64 / w["window_s"] / 1e6)


@pytest.mark.parametrize("seed", [tiny.SEED, 2**31 + 77, 2**33 + 9])
def test_no_traced_chunk_is_a_runs_reload_point(root, seed):
    r, starts = recorded(root, tiny.TINY_RUNS, seconds=1.0, traced=True, seed=seed)
    assert r["correct"], r["checks"]
    traced = r["window"]["traced"]
    t = generator.Traffic.load(manifest.cell(tiny.TINY_RUNS, root).traffic_path)
    assert len(traced) == t.trace_chunks == 2
    assert traced == list(range(traced[0], traced[0] + t.trace_chunks))
    # the slice starts at a run's first chunk, after its reload, and no
    # reload falls inside it
    assert traced[0] > 0 and t.starts_run(traced[0])
    assert not any(t.starts_run(i) for i in traced[1:])
    assert torch.equal(starts[traced[0]], starts[0])


@pytest.mark.parametrize("name", sorted(tiny.TINY) + [tiny.TINY_DS])
def test_the_loop_runs_and_checks_on_the_cpu(root, name):
    r = tiny.run(root, name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    m = r["metrics"]
    assert set(m) == {"mlups", "chunk_ms_p95", "peak_mem_gib", "setup_s"}
    assert m["mlups"]["value"] > 0 and m["chunk_ms_p95"]["value"] > 0
    assert set(r["checks"]) == set(manifest.cell(name, root).limits) | {check.FINITE}
    assert r["checks"][check.FINITE] == {"value": 0, "limit": 0}
    assert r["window"]["runs"] == math.ceil(r["attempted"] / 3)
    assert set(r["readings"]) == set(check.NUMBERS) - (
        set() if tiny.TINY.get(name, (None, None, False))[2] else {"probe_err"})
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


def test_the_percentile_is_over_every_value():
    assert generator.percentile(list(range(101)), 95) == 95
    assert generator.percentile([1.0, 2.0], 50) == 1.5
