"""The device's idle time a step while the host is inside the
`ctdd.train.update` span: the update launched onto an empty queue once the
host has read the loss (h100bench/spans.py), in ms."""

from h100bench import common, spans


def read(ctx):
    if not common.is_train(ctx):
        return None
    charges = spans.of(ctx)
    return None if charges is None else charges.idle_ms("ctdd.train.update")
