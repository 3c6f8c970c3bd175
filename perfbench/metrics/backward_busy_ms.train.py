"""backward_busy_ms.train (ms): per profiled training step, the union of
the device intervals launched inside the program's `trainer.backward`
span (from any thread: the autograd engine's included; each interval
whole, also past the span's end), in the stretch `perfbench/spans.py`
profiles. None where the trace holds no device event (the CPU)."""

from perfbench import spans


def read(ctx):
    p = spans.read(ctx)
    if ctx.drive != "train_epoch" or p is None or not p.trace.device \
            or not p.trace.named("trainer.backward"):
        return None
    return p.trace.busy_launched_in_us("trainer.backward") / 1e3 / p.units
