"""train_step_ms (ms): the window's length over the training steps
completed in it (each `train_epoch`: views, then the train step)."""


def read(ctx):
    if ctx.drive != "train_epoch" or ctx.units == 0:
        return None
    return 1e3 * ctx.window_s / ctx.units
