"""The check fails a run whose timed path is broken underneath: the
harness's look for a card is skipped and a tiny cell runs on the CPU
with one fault planted in the program, for each fault a one-card
lattice run can have (a step that returns its state unchanged, half of
the lattice left out, an answer altered where it is produced, a flow
that blows up after the checked chunk; there is no exchange between
chips: lbm_bench/faults.py). The cells keep the real cells' limits."""

import numpy as np
import pytest

import lbm_bench_tiny as tiny
from lbm_bench import check
from lbm_bench.faults import FAULTS, LATE_NAN_CHUNK, broken


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("faults"))


# each fault in each cell that compares the answer it alters: the series
# where probe_err is compared, Re where re_err is (PERF.md: the bf16 cell
# compares no Re)
ANSWER = {"series": "probe_err", "reynolds": "re_err"}
CASES = [(name, fault) for name in sorted(tiny.TINY) for fault in FAULTS
         if ANSWER.get(fault, "state_err") in tiny.limits_of(name)]


@pytest.mark.parametrize("name, fault", CASES)
def test_a_broken_timed_path_is_not_correct(root, name, fault):
    r = tiny.run(root, name, program=broken(fault))
    assert not r["correct"]
    assert r["failed"] >= 1
    assert any(not c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("name", sorted(tiny.TINY))
def test_the_same_run_unbroken_is_correct(root, name):
    assert tiny.run(root, name, program=broken("none"))["correct"]


@pytest.mark.parametrize("name", sorted(tiny.TINY))
def test_a_re_that_turns_nan_after_the_checked_chunk_is_not_correct(root, name):
    """Chunk k and the start still pass; the chunks whose Re is not a
    number fail the run on their own, and the first is named."""
    r = tiny.run(root, name, program=broken("late_nan"))
    assert r["attempted"] > LATE_NAN_CHUNK
    assert not r["correct"] and r["failed"] == 1
    assert r["readings"]["first_nonfinite_chunk"] == LATE_NAN_CHUNK
    assert r["checks"][check.FINITE] == {"value": r["attempted"] - LATE_NAN_CHUNK, "limit": 0}
    assert all(c["value"] <= c["limit"] for n, c in r["checks"].items() if n != check.FINITE)


def test_a_probe_sample_that_is_not_finite_fails_its_chunk():
    series = {i: np.ones((10, 3, 3)) for i in range(4)}
    series[1][7, 2, 0] = np.inf
    out = check.Outputs(reynolds={0: 1.0, 1: 2.0, 2: 3.0, 3: float("nan")}, series=series,
                        states={}, chunks_run=4)
    assert check.nonfinite_chunks(out) == [1, 3]
