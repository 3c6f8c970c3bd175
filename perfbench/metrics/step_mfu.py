"""step_mfu (%): the step's model FLOPs, counted from the traced step's
shapes by the recipe's `step_ops` (`lib/counts.py`), over the mean step
time of the traced run's timed steps (outside the profiled stretch) times
the card's float32 peak (`lib/peaks.py`)."""

from perfbench.metrics.lib import counts, peaks


def read(ctx):
    peak = peaks.peaks(ctx.device_kind)
    if ctx.drive != "train_epoch" or ctx.profile is None or peak is None \
            or ctx.units == 0:
        return None
    step_s = ctx.window_s / ctx.units
    flops = counts.total_flops(ctx.recipe.step_ops(ctx.profile.shapes))
    return 100.0 * flops / (step_s * peak["flops_f32"])
