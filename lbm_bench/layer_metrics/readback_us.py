"""readback_us (facade): the host time of Simulation.reynolds() after a
chunk, by the host clock, in microseconds: the mean over the window's
chunks before the profiler started."""


def read(ctx):
    times = [ctx.chunks[i].readback_s for i in ctx.untraced]
    return 1e6 * sum(times) / len(times) if times else None
