"""peak_mem_gib: the program's peak of torch.cuda.max_memory_allocated
over its set-up and the window, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30
