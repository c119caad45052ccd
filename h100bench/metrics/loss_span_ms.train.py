"""The loss's own device time a step in the real train step: what the
`ctdd.train.loss` span launches outside the network's span, forward and the
backward of those ops, charged through the profiler's launch correlation
and sequence numbers (h100bench/spans.py), in ms."""

from h100bench import common, spans


def read(ctx):
    if not common.is_train(ctx):
        return None
    charges = spans.of(ctx)
    return None if charges is None else charges.device_ms("ctdd.train.loss", self_only=True)
