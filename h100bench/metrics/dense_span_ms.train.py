"""The dense products' device time a step in the real train step:
everything the `ctdd.dense` span launches (q, k and v as one product, o,
the head), forward and backward, charged through the profiler's launch
correlation and sequence numbers (h100bench/spans.py), in ms; 0 in a cell
whose network opens no such span. None where the program has no such
span."""

import sys

from h100bench import common, spans

SPAN = "ctdd.dense"


def read(ctx):
    if not common.is_train(ctx):
        return None
    if SPAN not in getattr(sys.modules.get("ctdd_tpu_torch.utils.trace"), "SPANS", ()):
        return None
    charges = spans.of(ctx)
    return None if charges is None else charges.device_ms(SPAN)
