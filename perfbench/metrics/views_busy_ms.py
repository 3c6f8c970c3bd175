"""views_busy_ms (ms): the device's busy time per view pair over the
profiled pairs."""


def read(ctx):
    p = ctx.profile
    if ctx.drive != "views" or p is None or p.busy_s <= 0:
        return None
    return 1e3 * p.busy_s / p.units
