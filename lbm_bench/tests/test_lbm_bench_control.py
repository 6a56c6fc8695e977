"""The control, the configuration computed one precision lower, comes
out not correct: at a tiny size on the CPU here, and at each cell's own
size on the card (marked cuda; run there with
`python -m pytest lbm_bench/tests -m cuda`)."""

import time

import pytest
import torch

import lbm_bench_tiny as tiny
from lbm_bench import check, control, generator, harness, manifest


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("control"))


@pytest.mark.parametrize("name", sorted(tiny.TINY) + [tiny.TINY_DS])
def test_the_control_is_not_correct_on_the_cpu(root, name):
    r = tiny.run(root, name, **control.control_kwargs(manifest.cell(name, root).config))
    assert not r["correct"]


def test_the_pair_dp_cell_is_correct_on_the_cpu(root):
    """A program whose state is a (hi, lo) pair: loaded, snapshot and
    checked against the float64 reference."""
    r = tiny.run(root, tiny.TINY_DS)
    assert r["correct"], r["checks"]


def test_the_reference_in_the_programs_place_at_its_own_precision_is_correct(root):
    """The control's stand-in program is the reference: at the
    configuration's own storage it passes, so only the precision fails
    the control."""
    cfg = manifest.cell("tiny-bf16.steady", root).config
    r = tiny.run(root, "tiny-bf16.steady", **control.control_kwargs(
        cfg, {"by": "reference", "dtype": "bfloat16", "arithmetic": "float32"}))
    assert r["correct"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the port's kernels")


def first_chunk_seeds(cell, start: int, n: int) -> list[int]:
    """n seeds from `start` on whose checked chunk is the first, so a
    short window reaches it (the reference in the program's place runs a
    1000-step chunk of 4000x16000 in about half a minute)."""
    t = generator.Traffic.load(cell.traffic_path)
    return [s for s in range(start, start + 64 * n) if generator.checked_chunk(t, s) == 0][:n]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in manifest.load()["workloads"]])
def test_at_the_cells_size_the_program_is_correct_and_the_control_is_not(card, name):
    cell = manifest.cell(name)
    seed, control_seed = first_chunk_seeds(cell, 2**31 + 515, 2)
    r = harness.run_cell(cell, seed, 1.0, False, time.perf_counter(), emit=lambda s: None)
    assert r["correct"], r["checks"]
    r = harness.run_cell(cell, control_seed, 1.0, False, time.perf_counter(), emit=lambda s: None,
                         **control.control_kwargs(cell.config))
    assert set(r["checks"]) == set(cell.limits) | {check.FINITE}, \
        "the control's chunk was not checked"
    assert not r["correct"], r["checks"]
