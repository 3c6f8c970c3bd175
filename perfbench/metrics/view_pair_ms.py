"""view_pair_ms (ms): the window's length over the view pairs completed
in it (each `views()`, synced)."""


def read(ctx):
    if ctx.drive != "views" or ctx.units == 0:
        return None
    return 1e3 * ctx.window_s / ctx.units
