"""The network's device time a forward in the real sampling loop: what the
`ctdd.network` spans of a batch launch (h100bench/spans.py), over their
number (one a step, one more for the denoise), in ms."""

from h100bench import common, spans


def read(ctx):
    if not common.is_batches(ctx):
        return None
    charges = spans.of(ctx)
    if charges is None or not charges.calls.get("ctdd.network"):
        return None
    return charges.device_ms("ctdd.network") * charges.units / charges.calls["ctdd.network"]
