"""The yardstick: bytes and operations of a launch at the cells' shapes,
and a share that cannot pass 100% however many steps a launch runs."""

import pytest
import torch

from lbm_bench import roofline
from lbm_bench.reference import d2q9


@pytest.mark.parametrize("nx, ny, storage, mb, us", [
    (800, 4000, "float32", 230.4, 68.8),
    (4000, 16000, "bfloat16", 2304.0, 687.8),
])
def test_a_launch_at_the_cells_shapes(nx, ny, storage, mb, us):
    assert roofline.launch_bytes(nx, ny, storage) == pytest.approx(mb * 1e6)
    assert roofline.least_time_s(nx, ny, storage, 1) * 1e6 == pytest.approx(us, abs=0.05)
    # a class plane adds one byte a site
    assert roofline.launch_bytes(nx, ny, storage, plane=True) - \
        roofline.launch_bytes(nx, ny, storage) == nx * ny


@pytest.mark.parametrize("steps", [1, 2, 3, 6, 8, 16, 21, 32, 64])
def test_a_kernel_at_its_bound_reads_100_percent_at_any_depth(steps):
    t = roofline.least_time_s(800, 4000, "float32", steps)
    assert roofline.share([(steps, t)] * 5, 800, 4000, "float32") == pytest.approx(100.0)
    # deep passes become bound by operations, not bytes
    bytes_t = roofline.launch_bytes(800, 4000, "float32") / roofline.PEAK_BYTES_PER_S
    assert t == pytest.approx(max(bytes_t, roofline.launch_flops(800, 4000, steps)
                                  / roofline.PEAK_F32_FLOPS))


def test_mean_steps_a_launch_never_overstate():
    """Launches of uneven depth, each at its own bound: counted with the
    mean depth, the share stays at or under 100%."""
    depths = [1, 6, 6, 6, 21, 32]
    times = [roofline.least_time_s(800, 4000, "float32", s) for s in depths]
    mean = sum(depths) / len(depths)
    assert roofline.share([(mean, t) for t in times], 800, 4000, "float32") <= 100.0 + 1e-9
    assert roofline.share([], 800, 4000, "float32") is None


def test_flops_per_site_counts_the_reference_collision():
    """Count the additions, subtractions, multiplications and divisions
    that d2q9.collide runs on a plane, a site at a time."""
    counted = {"n": 0}
    ops = {"add", "sub", "mul", "div", "__add__", "__radd__", "__sub__", "__rsub__",
           "__mul__", "__rmul__", "__truediv__", "__rtruediv__"}

    class Count(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (getattr(func, "__name__", "") in ops and isinstance(out, torch.Tensor)
                    and out.shape == (3, 5)):
                counted["n"] += 1
            return out

    pulled = torch.rand(9, 3, 5) + 0.5
    with Count():
        d2q9.collide(pulled, d2q9.Params())
    assert counted["n"] == d2q9.flops_per_site() == 102
