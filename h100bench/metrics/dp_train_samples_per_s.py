"""Data-parallel training: the samples of every rank over all the window's
steps, over the window's time on rank 0 (host clock)."""


def read(ctx):
    if ctx.counters.get("ranks", 1) <= 1:
        return None
    return ctx.counters["samples"] / ctx.counters["window_s"]
