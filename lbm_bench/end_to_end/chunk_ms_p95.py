"""chunk_ms_p95: the 95th percentile, over all the window's chunks, of a
chunk's wall time from the call that starts its steps to the host
holding its readback, in ms."""

from lbm_bench import generator


def read(ctx):
    return generator.percentile([c.seconds for c in ctx.chunks], 95) * 1e3
