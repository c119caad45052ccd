"""The fused tau-leap kernel against its bound: the least time its bytes
take at 3.35 TB/s (common.fused_tau_leap_bytes: each input read once, each
output written once) over its mean device time, the kernel found by name
in the trace, in percent."""


def read(ctx):
    if ctx.trace is None or "fused_tau_leap_bytes" not in ctx.counters:
        return None
    times = ctx.trace.kernel_us("fused_tau_leap")
    if not times:
        return None
    bound_s = ctx.counters["fused_tau_leap_bytes"] / ctx.peak_bytes_per_s
    return 100.0 * bound_s / (sum(times) / len(times) / 1e6)
