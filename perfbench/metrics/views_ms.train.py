"""views_ms.train (ms): the host's time of `views()` between two syncs,
per step, over the traced run's timed steps (the harness's own span)."""


def read(ctx):
    if ctx.drive != "train_epoch" or not ctx.views_s:
        return None
    return 1e3 * sum(ctx.views_s) / len(ctx.views_s)
