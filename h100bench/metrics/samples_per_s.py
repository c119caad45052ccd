"""Offline generation: all the samples of all the window's whole batches
over the time until the last batch ended (host clock)."""


def read(ctx):
    if "batches" not in ctx.counters:
        return None
    return ctx.counters["samples"] / ctx.counters["window_s"]
