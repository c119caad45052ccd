"""The network's device time a step in the real train step: everything the
`ctdd.network` span launches, forward and backward, charged through the
profiler's launch correlation and sequence numbers (h100bench/spans.py), in
ms."""

from h100bench import common, spans


def read(ctx):
    if not common.is_train(ctx):
        return None
    charges = spans.of(ctx)
    return None if charges is None else charges.device_ms("ctdd.network")
