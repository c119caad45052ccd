"""One network forward at the cell's batch, timed alone between CUDA
events over 20 back-to-back calls, in ms."""

from h100bench import common


def read(ctx):
    probe = ctx.probes.get("network_forward")
    return None if probe is None else common.cuda_ms(probe, 20)
