"""The expert layer's device time a step in the real train step: what the
`ctdd.moe.route` (router, top-k, sort, gather) and `ctdd.moe.experts` (the
held experts' products, the weighted scatter-add) spans launch, forward and
backward (h100bench/spans.py), in ms; 0 in a cell whose network opens
neither span. None where the program has no such spans."""

import sys

from h100bench import common, spans

SPANS = ("ctdd.moe.route", "ctdd.moe.experts")


def read(ctx):
    if not common.is_train(ctx):
        return None
    named = getattr(sys.modules.get("ctdd_tpu_torch.utils.trace"), "SPANS", ())
    if not set(SPANS) <= set(named):
        return None
    charges = spans.of(ctx)
    return None if charges is None else sum(charges.device_ms(s) for s in SPANS)
