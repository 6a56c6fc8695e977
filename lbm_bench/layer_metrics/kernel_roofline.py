"""kernel_roofline (step kernels), in %: the least time of the profiled
step-kernel launches over their card time, counted per launch by
lbm_bench/roofline.py (one state read and one written, a class plane
where one is read; the launch's steps times the reference's operations
of a site update, at the H100's published peaks). The profiled chunks
ran steps_per_chunk steps each; each launch is given the mean steps a
launch, which can only lower the summed least time (the larger of two
bounds is convex in the steps), so the share never overstates."""

from lbm_bench import roofline


def read(ctx):
    view = ctx.view
    if view is None:
        return None
    launches = [e.dur * 1e-6 for e in view.device if view.is_step_kernel(e)]
    if not launches:
        return None
    steps = ctx.traced_steps / len(launches)
    cfg = ctx.cell.config
    return roofline.share([(steps, s) for s in launches], cfg.nx, cfg.ny, cfg.dtype, ctx.plane)
