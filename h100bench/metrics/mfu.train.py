"""The window's training on one card as a share of its dense bf16 peak:
three times the reference network's forward FLOPs at the batch
(FlopCounterMode over the shapes) per step, times the steps, over the
window's time and 989 TFLOP/s, in percent."""


def read(ctx):
    c = ctx.counters
    if "flops_per_step" not in c or c.get("ranks") != 1:
        return None
    return 100.0 * c["flops_per_step"] * c["steps"] / c["window_s"] / ctx.peak_flops
