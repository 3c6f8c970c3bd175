"""views_idle_ms.train (ms): per profiled training step, the length of the
program's `trainer.views` span less the device's busy time inside it
(the union of kernel, memcpy and memset intervals clipped to the span),
in the stretch `perfbench/spans.py` profiles. None where the trace holds
no device event (the CPU)."""

from perfbench import spans


def read(ctx):
    p = spans.read(ctx)
    if ctx.drive != "train_epoch" or p is None or not p.trace.device \
            or not p.trace.named("trainer.views"):
        return None
    return p.trace.idle_in_us("trainer.views") / 1e3 / p.units
