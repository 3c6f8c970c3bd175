"""encoder_roofline (%): the encoder's least time over its device time.
The encoder (`nn/gcn.py` on `ops/spmm.py`) is called alone on both of the
traced step's views, forward and backward, in a span of its own; its
device time is the device's busy time in that span, whatever kernels run
there. The least time sums, over the layer's operations (`lib/counts.py`:
the normalisation, each layer's product, sparse aggregation and their
backward), the larger of FLOPs over the peak rate and bytes over the peak
bandwidth."""

from perfbench.metrics.lib import counts, peaks


def read(ctx):
    peak = peaks.peaks(ctx.device_kind)
    p = ctx.profile
    if p is None or peak is None or not p.layer_busy_s.get("encoder"):
        return None
    least = counts.least_seconds(
        ctx.recipe.layer_ops("encoder", p.shapes), peak)
    return 100.0 * least / p.layer_busy_s["encoder"]
