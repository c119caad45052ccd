"""The dense products against their peak: three times their forward FLOPs
(forward, the input's gradient and the weight's gradient) a step, counted
from the configuration's shapes (q, k, v and o over the 2L positions of
every layer, the head over the noisy half), over the device time a step
charged to the `ctdd.dense` span (h100bench/spans.py), in percent.

The peak is 494.7 / 3 TFLOP/s: a float32 product at float32 accuracy on the
tensor cores takes three TF32 products, and the H100 SXM's dense TF32 peak
is 494.7 TFLOP/s (NVIDIA's data sheet). The span, not a kernel's name, gives
the time, so whatever runs the products is measured. None where the cell
has no such network, the trace holds no device operation, or the program
opens no such span."""

import math
import sys

from h100bench import common, spans

SPAN = "ctdd.dense"
PEAK = 494.7e12 / 3.0


def dense_forward_flops(cfg: dict, batch: int) -> float:
    m = cfg["model"]
    L = math.prod(cfg["data"]["shape"])
    d, H, KV, Dh = m["hidden_size"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    per_position = 2.0 * d * (H + 2 * KV) * Dh + 2.0 * H * Dh * d
    head = 2.0 * d * m["vocab_size"] * L
    return batch * (m["num_layers"] * 2 * L * per_position + head)


def read(ctx):
    if ctx.trace is None or not ctx.trace.device or not common.is_train(ctx) or \
            "block_length" not in ctx.cfg.get("model", {}):
        return None
    if SPAN not in getattr(sys.modules.get("ctdd_tpu_torch.utils.trace"), "SPANS", ()):
        return None
    charges = spans.of(ctx)
    ms = None if charges is None else charges.device_ms(SPAN)
    if not ms:
        return None
    flops = 3.0 * dense_forward_flops(ctx.cfg, int(ctx.cfg["data"]["batch_size"]))
    return 100.0 * flops / (ms / 1e3) / PEAK
