"""The window's generation as a share of the card's dense bf16 peak: the
reference network's forward FLOPs per batch (FlopCounterMode over the
shapes, every step and the denoise) times the window's batches, over the
window's time and 989 TFLOP/s, in percent."""


def read(ctx):
    c = ctx.counters
    if "flops_per_batch" not in c:
        return None
    return 100.0 * c["flops_per_batch"] * c["batches"] / c["window_s"] / ctx.peak_flops
