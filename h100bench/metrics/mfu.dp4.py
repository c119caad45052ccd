"""The window's data-parallel training as a share of the cards' dense bf16
peaks: three times the reference network's forward FLOPs at the global
batch per step, times the steps, over the window's time and the ranks'
989 TFLOP/s each, in percent."""


def read(ctx):
    c = ctx.counters
    if "flops_per_step" not in c or c.get("ranks", 1) <= 1:
        return None
    return 100.0 * c["flops_per_step"] * c["steps"] / c["window_s"] / (
        c["ranks"] * ctx.peak_flops)
