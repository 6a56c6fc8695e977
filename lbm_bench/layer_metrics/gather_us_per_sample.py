"""gather_us_per_sample (probe gather): card microseconds, per probe
sample, of the operations launched inside the program's probed call that
are not step kernels (kernels, copies, sets; kernels told apart by
function name, trace.kernel_function)."""


def read(ctx):
    view = ctx.view
    samples = len(ctx.traced) * ctx.traffic.samples_per_chunk
    if view is None or not samples:
        return None
    ops = [e for e in view.device if not view.is_step_kernel(e) and view.launched_in(e, view.steps)]
    return sum(e.dur for e in ops) / samples if ops else None
