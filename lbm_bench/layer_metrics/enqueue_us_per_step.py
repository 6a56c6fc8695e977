"""enqueue_us_per_step (session loop): host microseconds a step takes to
enqueue, from the trace: in each profiled chunk, from the start of the
call into the program to the end of its last kernel-launch call (a
probed run fetches its series at its end, so the call's own return
holds the card's whole time), over the chunk's steps; the mean over the
profiled chunks."""


def read(ctx):
    view = ctx.view
    if view is None:
        return None
    per_step = []
    calls = [e for e in view.launches if "Launch" in e.name]
    for a, b in view.steps:
        ends = [e.end for e in calls if a <= e.start <= b]
        if ends:
            per_step.append((max(ends) - a) / ctx.traffic.steps_per_chunk)
    return sum(per_step) / len(per_step) if per_step else None
