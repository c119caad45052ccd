"""The share of the traced segment in which no operation ran on the card:
1 - (the union of the device operations' intervals) / (the segment's
length), in percent (torch.profiler trace, rank 0)."""

from h100bench import common


def read(ctx):
    if ctx.trace is None or not common.is_dp(ctx):
        return None
    return common.idle_share_pct(ctx.trace)
