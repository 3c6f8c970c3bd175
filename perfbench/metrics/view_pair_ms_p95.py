"""view_pair_ms_p95 (ms): the 95th percentile of the latency of every
view pair of the window (`statistics.quantiles`, exclusive method)."""

import statistics


def read(ctx):
    if ctx.drive != "views" or len(ctx.latencies) < 2:
        return None
    return 1e3 * statistics.quantiles(ctx.latencies, n=20)[-1]
