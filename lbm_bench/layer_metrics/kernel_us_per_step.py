"""kernel_us_per_step (step kernels): card microseconds of the step
kernels (function name lbm_*, trace.kernel_function) over the steps the
profiled chunks ran."""


def read(ctx):
    view = ctx.view
    if view is None:
        return None
    busy = sum(e.dur for e in view.device if view.is_step_kernel(e))
    return busy / ctx.traced_steps if busy else None
