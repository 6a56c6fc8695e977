"""The flat multi-step kernel's pass plan and tiling on the CPU.

csrc/lbm_flat_step.cu runs passes of up to T (`temporal`) steps in shared
memory: flat_schedule is its pass plan, flat_output the output tile a
pass leaves, and flat_reference_blocked its tiling in plain PyTorch
(tiles, halos by
modulo, levels that shrink by one site, forcing at global column 0, the
pass plan). Here the plan is checked exactly and flat_reference_blocked
bitwise, the whole stacked pair, against flat_reference (n chained
single steps): the tiling computes the same values in the same order, so
the bar is equality, float32 and bf16 alike. tests/test_torch_cuda.py
holds the kernel against both on a card.
"""

import numpy as np
import pytest
import torch

from latticeboltzmann_tpu_torch import LatticeConfig
from latticeboltzmann_tpu_torch.models.engine import initial_state
from latticeboltzmann_tpu_torch.ops import fused_kernel as fk
from latticeboltzmann_tpu_torch.utils import interop

torch.set_num_threads(1)

DTYPES = [np.float32, "bfloat16"]
TEMPORALS = [1, 2, 3, 4, 8]


# ---- the pass plan ----

@pytest.mark.parametrize("temporal", [1, 2, 3, 4, 5, 8, 32])
@pytest.mark.parametrize("n_steps", [2, 4, 8, 10, 16, 48, 64, 96, 1008])
def test_flat_schedule_covers_the_steps_and_returns_to_parity_0(n_steps, temporal):
    """Every pass at most T steps; an odd count of them covers the first
    n - 1 steps (so they end at parity 1, one step earlier), the fewest
    such, as even as they go; then one pass of one step into parity 0.
    The runs the kernel takes spell the same plan."""
    plan = fk.flat_schedule(n_steps, temporal)
    head = plan[:-1]
    assert sum(plan) == n_steps and plan[-1] == 1
    assert len(head) % 2 == 1 and all(1 <= p <= temporal for p in plan)
    fewest = -(-(n_steps - 1) // temporal)
    assert len(head) == fewest + 1 - fewest % 2
    assert max(head) - min(head) <= 1
    runs = fk._flat_runs(plan)
    steps, counts = runs[:fk.FLAT_RUNS], runs[fk.FLAT_RUNS:]
    assert sum(((s,) * c for s, c in zip(steps, counts)), ()) == plan


@pytest.mark.parametrize("n_steps, temporal, plan", [
    (2, 8, (1, 1)), (8, 4, (3, 2, 2, 1)), (16, 4, (3, 3, 3, 3, 3, 1)), (16, 5, (5, 5, 5, 1)),
    (16, 8, (5, 5, 5, 1)), (16, 1, (1,) * 16), (48, 3, (3,) * 13 + (2,) * 4 + (1,)),
])
def test_flat_schedule_plans(n_steps, temporal, plan):
    assert fk.flat_schedule(n_steps, temporal) == plan


@pytest.mark.parametrize("n_steps, temporal", [(3, 4), (0, 1), (16, 0), (16, 33), (16, 2.0),
                                               (4.0, 2)])
def test_flat_schedule_refusals(n_steps, temporal):
    with pytest.raises(ValueError):
        fk.flat_schedule(n_steps, temporal)


# ---- the tile ----

@pytest.mark.parametrize("temporal", [1, 2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_output_leaves_halos_of_whole_vectors(dtype, temporal):
    """A pass of L steps keeps L rows on each side of its output and at
    least L columns, rounded up to whole 16-byte vectors, so that a
    tile's loads are whole vectors."""
    tile = fk.FlatTile(44, 72)
    v = fk.WIDE_COLUMNS[dtype]
    for steps in (1, temporal):
        rows, cols = fk.flat_output(tile, dtype, steps)
        pad = (tile.width - cols) // 2
        assert rows == tile.rows - 2 * steps and cols == tile.width - 2 * pad
        assert pad % v == 0 and steps <= pad < steps + v


# ---- the tiling against n chained steps ----

def _state(cfg, seed=7):
    """tests/test_pallas.py:830-832's rough positive state; the forcing
    guard fails at one column-0 site."""
    rng = np.random.default_rng(seed)
    f = np.asarray(initial_state(cfg), np.float64)
    f = (f * (1.0 + 0.05 * rng.random(f.shape))).astype(np.float32)
    f[6, cfg.nx // 2, 0] = 1e-6
    return interop.state_tensor(f, cfg.dtype, "cpu")


SCENES = {
    "16x40": dict(nx=16, ny=40),
    "24x40-accel": dict(nx=24, ny=40, accel=0.005),
    "5x3-under-one-tile": dict(nx=5, ny=3, accel=0.005),
    "37x1001-ragged": dict(nx=37, ny=1001),
}


def _small_tile(dtype, temporal):
    """A tile of 3 output rows and 2 output vectors of columns at T steps
    (more of each in shorter passes): many tiles, ragged in both axes."""
    v = fk.WIDE_COLUMNS[dtype]
    pad = -(-temporal // v) * v
    return fk.FlatTile(2 * temporal + 3, 2 * pad + 2 * v)


def _kernel_like_tile(dtype):
    """The kernel's 72 columns, with the rows two CTAs per SM leave on an
    H100 (flat_tile reads them from the card)."""
    return fk.FlatTile(44 if dtype == torch.float32 else 88, 72)


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("temporal", TEMPORALS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flat_reference_blocked_equals_flat_reference(dtype, temporal, scene):
    """The kernel's tiling, at a tile of the kernel's shape and at a small
    one, bitwise equal to flat_reference over the whole stacked pair
    (parity 1: one step earlier) for 2, 8 and 16 steps and 12 (11 steps
    before the last pass, no multiple of T > 1). 37x1001 at the kernel's
    shape only."""
    cfg = LatticeConfig(dtype=dtype, **SCENES[scene])
    t = _state(cfg)
    f2 = torch.stack([t, torch.full_like(t, float("nan"))])
    tiles = [_kernel_like_tile(t.dtype)]
    counts = (2, 12) if scene.startswith("37") else (2, 8, 16, 12)
    if not scene.startswith("37"):
        tiles.append(_small_tile(t.dtype, temporal))
    for n in counts:
        want = fk.flat_reference(f2, cfg, n)
        for tile in tiles:
            got = fk.flat_reference_blocked(f2, cfg, n, temporal, tile)
            assert got.dtype == t.dtype and torch.equal(got, want), (n, tile)


def test_flat_reference_blocked_leaves_its_input():
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    t = _state(cfg)
    f2 = torch.stack([t, t])
    before = f2.clone()
    fk.flat_reference_blocked(f2, cfg, 4, 2, _kernel_like_tile(torch.float32))
    assert torch.equal(f2, before)


def test_flat_reference_blocked_refuses_a_tile_with_no_output():
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    t = _state(cfg)
    with pytest.raises(ValueError):
        fk.flat_reference_blocked(torch.stack([t, t]), cfg, 4, 4, fk.FlatTile(8, 72))
    with pytest.raises(ValueError):
        fk.flat_reference_blocked(torch.stack([t, t]), cfg, 4, 4, fk.FlatTile(20, 8))


# ---- the wrapper's temporal ----

@pytest.mark.parametrize("temporal", TEMPORALS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flat_step_on_cpu_does_not_depend_on_temporal(dtype, temporal):
    """On the CPU the wrapper writes flat_reference's result at any T, with
    no launch counted."""
    cfg = LatticeConfig(nx=16, ny=40, dtype=dtype, accel=0.005)
    t = _state(cfg)
    before = fk.FLAT_LAUNCHES
    got = fk.make_flat_step(cfg, 8, temporal=temporal)(torch.stack([t, t]))
    assert torch.equal(got, fk.flat_reference(torch.stack([t, t]), cfg, 8))
    assert fk.FLAT_LAUNCHES == before


@pytest.mark.parametrize("case", ["temporal0", "temporal_big", "temporal_float", "odd_steps",
                                  "blocks0", "temporal_str", "make_temporal"])
def test_flat_step_refuses_a_depth_or_tile_the_kernel_does_not_take(case):
    cfg = LatticeConfig(nx=16, ny=40, dtype=np.float32)
    t = _state(cfg)
    f2 = torch.stack([t, t])
    calls = {
        "temporal0": lambda: fk.flat_step(f2, cfg, 4, temporal=0),
        "temporal_big": lambda: fk.flat_step(f2, cfg, 4, temporal=fk.FLAT_MAX_TEMPORAL + 1),
        "temporal_float": lambda: fk.flat_step(f2, cfg, 4, temporal=2.0),
        "odd_steps": lambda: fk.flat_step(f2, cfg, 3, temporal=2),
        "blocks0": lambda: fk.flat_step(f2, cfg, 4, temporal=2, blocks=0),
        "temporal_str": lambda: fk.flat_step(f2, cfg, 4, temporal="4"),
        "make_temporal": lambda: fk.make_flat_step(cfg, 4, temporal=-1),
    }
    before = f2.clone()
    with pytest.raises(ValueError):
        calls[case]()
    assert torch.equal(f2, before)
