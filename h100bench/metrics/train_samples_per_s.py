"""Training on one card: the samples of all the window's steps over the
window's time (host clock)."""


def read(ctx):
    if ctx.counters.get("ranks") != 1:
        return None
    return ctx.counters["samples"] / ctx.counters["window_s"]
