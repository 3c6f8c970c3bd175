"""ppr_roofline (%): the PPR series' least time over its device time. The
series (`augment/diffusion.py::compute_ppr_dense` on `ops/spmm.py`) is
called alone on a Schur complement the recipe makes before the layer's
span, in a span of its own; its device time is the device's busy time in
that span, whatever kernels run there. The least time sums, over the
series' steps (the recipe's `layer_ops("ppr", ...)` from `lib/counts.py`:
one sparse product of the dense [n, n] S over T's nonzero entries and
the alpha added to the diagonal),
the larger of FLOPs over the peak rate and bytes over the peak
bandwidth. None where the recipe has no such layer."""

from perfbench.metrics.lib import counts, peaks


def read(ctx):
    peak = peaks.peaks(ctx.device_kind)
    p = ctx.profile
    if p is None or peak is None or not p.layer_busy_s.get("ppr"):
        return None
    least = counts.least_seconds(ctx.recipe.layer_ops("ppr", p.shapes), peak)
    return 100.0 * least / p.layer_busy_s["ppr"]
