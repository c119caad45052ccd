"""Seconds from the start of the process to the first timed step: imports,
the CUDA context, the kernels built or loaded, the weights and data made on
the card, every shape of the cell warmed up (host clock)."""


def read(ctx):
    return ctx.setup_s
