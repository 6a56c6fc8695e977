"""The check fails a run whose timed path is broken underneath: the
harness's look for a card is skipped and a tiny cell runs on the CPU
with one fault planted in the program, for each fault a one-card
lattice run can have (a step that returns its state unchanged, half of
the lattice left out, an answer altered where it is produced; there is
no exchange between chips: lbm_bench/faults.py). The cells keep the real
cells' limits."""

import pytest

import lbm_bench_tiny as tiny
from lbm_bench.faults import FAULTS, broken


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
