"""The block attention's kernels against their peak: the FLOPs of the
pairs the block-diffusion mask keeps, forward and backward (3.5x the
forward's `reference/sdar_moe.py::attention_flops`: the backward recomputes
the scores and takes four products to the forward's two), a step, over the
device time a step of the kernels found by name in the trace
(`fmha_cutlass`: F.scaled_dot_product_attention's memory-efficient
kernels, forward and backward), in percent.

The peak is 494.7 / 3 TFLOP/s: from sm80 on, the memory-efficient kernel
takes a float32 product as three TF32 products on the tensor cores
(CUTLASS's OpMultiplyAddFastF32, float32's accuracy), and the H100 SXM's
dense TF32 peak is 494.7 TFLOP/s (NVIDIA's data sheet). Work the kernels
do on pairs the mask drops (the tiles' masked corners) counts as time, not
as FLOPs. None where the cell has no block attention or the trace holds no
such kernel."""

from h100bench import common

KERNEL = "fmha_cutlass"
PEAK = 494.7e12 / 3.0
BACKWARD_OVER_FORWARD = 2.5


def read(ctx):
    if ctx.trace is None or not common.is_train(ctx) or \
            "block_length" not in ctx.cfg.get("model", {}):
        return None
    times = ctx.trace.kernel_us(KERNEL)
    if not times:
        return None
    family = common.load_module(common.HERE / "reference" / "sdar_moe.py")
    flops = (1.0 + BACKWARD_OVER_FORWARD) * family.attention_flops(
        ctx.cfg, int(ctx.cfg["data"]["batch_size"]))
    seconds = sum(times) / 1e6 / ctx.trace.units
    return 100.0 * flops / seconds / PEAK
