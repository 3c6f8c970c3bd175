"""idle_share.train (%): 1 - busy / span over the profiled training steps,
busy the union of the device's kernel, memcpy and memset intervals."""


def read(ctx):
    p = ctx.profile
    if ctx.drive != "train_epoch" or p is None or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
