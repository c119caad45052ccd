"""The update's device time a step in the real train step: what the
`ctdd.train.update` span launches (the non-finite skip, clip, Adam, EMA;
h100bench/spans.py), in ms."""

from h100bench import common, spans


def read(ctx):
    if not common.is_train(ctx):
        return None
    charges = spans.of(ctx)
    return None if charges is None else charges.device_ms("ctdd.train.update")
