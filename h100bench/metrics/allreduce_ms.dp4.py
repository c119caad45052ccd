"""Device time a step of the NCCL kernels on rank 0, found by name in the
trace, in ms."""


def read(ctx):
    if ctx.trace is None or ctx.counters.get("ranks", 1) <= 1:
        return None
    times = ctx.trace.kernel_us("nccl")
    if not times:
        return None
    return sum(times) / 1e3 / ctx.trace.units
