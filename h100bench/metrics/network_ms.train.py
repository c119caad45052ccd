"""The network's forward and backward alone at the cell's batch: their
device operations summed from a torch.profiler trace, per call, in ms."""

from h100bench import common


def read(ctx):
    probe = ctx.probes.get("network_fwd_bwd")
    return None if probe is None else common.device_ms(probe, 5)
