"""idle_share.views (%): 1 - busy / span over the profiled view pairs."""


def read(ctx):
    p = ctx.profile
    if ctx.drive != "views" or p is None or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
