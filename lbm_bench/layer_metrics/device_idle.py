"""device_idle (device), in %: the share of the profiled slice (from the
first profiled chunk's start to the last one's end, by the host clock
of the trace) in which the card ran no kernel, copy or set."""


def read(ctx):
    view = ctx.view
    if view is None or view.window_us <= 0 or not view.device:
        return None
    return 100.0 * (1.0 - view.busy_us() / view.window_us)
