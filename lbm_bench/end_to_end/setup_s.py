"""setup_s: from the process's start to the first timed chunk, in s."""


def read(ctx):
    return ctx.setup_s
