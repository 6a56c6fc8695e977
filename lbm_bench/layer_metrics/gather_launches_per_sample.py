"""gather_launches_per_sample (probe gather): the card operations per
probe sample launched inside the program's probed call that are not step
kernels (the ones gather_us_per_sample times)."""


def read(ctx):
    view = ctx.view
    samples = len(ctx.traced) * ctx.traffic.samples_per_chunk
    if view is None or not samples:
        return None
    n = sum(1 for e in view.device if not view.is_step_kernel(e) and view.launched_in(e, view.steps))
    return n / samples if n else None
