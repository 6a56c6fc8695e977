"""The yardstick of the step kernels: the published peaks of the card and
the bytes and operations a launch needs.

A step-kernel launch runs `steps` site updates of every site of the
lattice between two states. Whatever it does inside, it has to read one
state and write one state in their storage dtype, and a launch that
reads a class plane reads it once (one byte a site). Its operations are
the sites times the steps of that launch times the float32 operations of
one site update in the reference (reference/d2q9.flops_per_site): the
arithmetic is float32 for bf16 storage too. So the least time of a
launch is the larger of its bytes over the peak bandwidth and its
operations over the peak float32 rate, and counted per launch it stays
a bound however many steps a launch runs.
"""

from __future__ import annotations

from .reference import d2q9

# NVIDIA H100 SXM5 80GB data sheet: HBM3 bandwidth and dense float32
# rate outside the tensor cores, both at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# bytes a value in storage; float64 stands for a (hi, lo) float32 pair too
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float64": 8}


def launch_bytes(nx: int, ny: int, storage: str, plane: bool = False) -> int:
    """One state read and one written in `storage`, plus a uint8 class
    plane where the launch reads one."""
    return 2 * d2q9.NSPEEDS * nx * ny * ITEMSIZE[storage] + (nx * ny if plane else 0)


def launch_flops(nx: int, ny: int, steps: int) -> int:
    return nx * ny * steps * d2q9.flops_per_site()


def least_time_s(nx: int, ny: int, storage: str, steps: int, plane: bool = False) -> float:
    """The least time of one launch of `steps` steps on the card."""
    return max(launch_bytes(nx, ny, storage, plane) / PEAK_BYTES_PER_S,
               launch_flops(nx, ny, steps) / PEAK_F32_FLOPS)


def share(launches: list[tuple[int, float]], nx: int, ny: int, storage: str,
          plane: bool = False) -> float | None:
    """The roofline share in %: summed least time over summed card time
    of launches given as (steps in the launch, card seconds); None when
    there is no launch."""
    if not launches:
        return None
    least = sum(least_time_s(nx, ny, storage, steps, plane) for steps, _ in launches)
    busy = sum(seconds for _, seconds in launches)
    return 100.0 * least / busy
