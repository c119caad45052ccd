"""The update alone (the non-finite check, clip, Adam, EMA) on the cell's
parameters: its device operations summed from a torch.profiler trace, per
call, in ms."""

from h100bench import common


def read(ctx):
    probe = ctx.probes.get("update")
    return None if probe is None else common.device_ms(probe, 5)
