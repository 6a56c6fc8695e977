"""The cuda session's depth swept on a CUDA card: the measurement behind
fused_kernel.DEFAULT_TEMPORAL, the depth Session(temporal=None) runs.

For each shape, the flow is first developed from the rest state for
`--develop` steps at the default depth (the benchmark's cells run a
developed flow, where the float32 pass runs slower than from rest;
PERF.md); then a Session(temporal=T) per depth, each loaded with that
state, on the reference scene (geometry.reference_barrier, the wall spec
variant, as the cells run it) advances `--steps` steps a run (a cell's
chunk), the depths in turns, forward then reversed, `--rounds` times. A run is timed
by CUDA events around Session.advance from a synchronized card (the pace
with the host's launches, as a chunk runs) and again queued behind a
spin (utils.timing.queued_ms: the card's time alone). Each shape prints
one JSON line: per depth the median and best us a step of both timings
and the median pace's share of T=1's, the fastest depth by median pace,
and the depth default_temporal gives there. The first line printed is
the card's name and power limit. Without a CUDA card the script exits 2.

Usage:  python -m latticeboltzmann_tpu_torch.scripts.depth_sweep
            [--depths 1,4,5,6,7,8] [--steps 1000] [--rounds 3] [--develop 100000]
            [--shapes 800x4000:float32,4000x16000:bfloat16,...]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

# the benchmark's two configurations, then the other storage at each size
SHAPES = "800x4000:float32,4000x16000:bfloat16,4000x16000:float32,800x4000:bfloat16"
DEPTHS = "1,4,5,6,7,8"
# steps from rest before timing: at 800x4000 float32 the pass reaches its
# developed-flow pace after about 77,000 (PERF.md)
DEVELOP = 100_000


def _shapes(text: str) -> list[tuple[int, int, str]]:
    out = []
    for item in text.split(","):
        size, dtype = item.split(":")
        nx, ny = size.split("x")
        out.append((int(nx), int(ny), dtype))
    return out


def advance_us(sess, steps: int) -> tuple[float, float]:
    """(pace, card) us a step of sess.advance(steps): CUDA events from a
    synchronized card, then queued behind a spin."""
    from ..utils.timing import queued_ms

    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    sess.advance(steps)
    e1.record()
    torch.cuda.synchronize()
    pace = e0.elapsed_time(e1) * 1e3 / steps
    return pace, queued_ms(lambda: sess.advance(steps), 1) * 1e3 / steps


def sweep(nx: int, ny: int, dtype: str, depths: list[int], steps: int, rounds: int,
          develop: int = 0) -> dict:
    """One shape's sweep from the state `develop` steps past rest:
    {"shape", "developed_steps", "depths": {T: {...}}, "fastest",
    "default"} (module docstring)."""
    from ..core import geometry
    from ..core.spec import LatticeConfig
    from ..models.engine import initial_state
    from ..ops import fused_kernel as fk
    from ..utils.interop import state_tensor

    cfg = LatticeConfig(nx=nx, ny=ny, dtype=dtype)
    walls = geometry.reference_barrier(nx, ny)
    spec = geometry.infer_spec(walls)
    f = state_tensor(initial_state(cfg), cfg.dtype, "cuda")
    if develop:
        flow = fk.Session(cfg, walls, device="cuda", wall_spec=spec)
        flow.load(f)
        flow.advance(develop)
        f = flow.unload()
        del flow
    sessions = {}
    for depth in depths:
        sess = sessions[depth] = fk.Session(cfg, walls, device="cuda", wall_spec=spec,
                                            temporal=depth)
        sess.load(f)
        sess.advance(steps)  # the first launches of each depth, outside the timing
    del f
    runs = {depth: [] for depth in depths}
    for r in range(rounds):
        for depth in (depths if r % 2 == 0 else depths[::-1]):
            runs[depth].append(advance_us(sessions[depth], steps))
    st = fk._storage(cfg)
    most = fk.temporal_info(st)["max_steps"]
    table = {}
    for depth, times in runs.items():
        pace, card = [t[0] for t in times], [t[1] for t in times]
        table[depth] = {"pace_us_median": statistics.median(pace), "pace_us_best": min(pace),
                        "card_us_median": statistics.median(card), "card_us_best": min(card)}
    if 1 in table:
        for row in table.values():
            row["pace_share_of_T1"] = row["pace_us_median"] / table[1]["pace_us_median"]
    return {"shape": f"{nx}x{ny} {dtype}", "developed_steps": develop, "steps": steps,
            "rounds": rounds,
            "depths": {str(d): row for d, row in table.items()},
            "fastest": min(table, key=lambda d: table[d]["pace_us_median"]),
            "default": fk.default_temporal(st, ny, "cuda", most)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", default=DEPTHS)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--shapes", default=SHAPES)
    ap.add_argument("--develop", type=int, default=DEVELOP,
                    help="steps from rest before timing (0: time from rest)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("depth_sweep needs a CUDA card: the temporal form has no timing off one",
              file=sys.stderr)
        return 2
    from ..bench import card_info

    print(card_info(), flush=True)
    depths = [int(d) for d in args.depths.split(",")]
    for nx, ny, dtype in _shapes(args.shapes):
        print(json.dumps(sweep(nx, ny, dtype, depths, args.steps, args.rounds, args.develop)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
