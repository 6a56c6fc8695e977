"""mlups: every site update of every chunk of the window over the
window's wall time (host clock), in millions a second."""


def read(ctx):
    steps = len(ctx.chunks) * ctx.traffic.steps_per_chunk
    return steps * ctx.cell.config.nx * ctx.cell.config.ny / ctx.window_s / 1e6
