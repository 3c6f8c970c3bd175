"""diffusion_share.train (%): the device's busy time launched inside the
program's `diffusion.build` spans (any thread, each interval whole) over
its busy time in the whole stretch `perfbench/spans.py` profiles, which
holds one build a refresh cycle. None where the trace holds no device
event (the CPU) or no build."""

from perfbench import spans


def read(ctx):
    p = spans.read(ctx)
    if ctx.drive != "train_epoch" or p is None or not p.trace.device \
            or not p.trace.named("diffusion.build"):
        return None
    lo, hi = p.trace.stretch
    busy = p.trace.busy_us(lo, hi)
    if busy <= 0:
        return None
    return 100.0 * p.trace.busy_launched_in_us("diffusion.build") / busy
