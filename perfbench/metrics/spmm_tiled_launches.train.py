"""spmm_tiled_launches.train (count): the `spmm` kernel launches (forward
and dx) whose grid has more than one column tile, a row wider than a
warp's tile split over warps, per training step: the program's counter
`spmm.tiled` (`ops/spmm.py`) over the steps `perfbench/spans.py`
profiles. 0.64 in a refresh cycle of 50 steps that builds one PPR view
(32 products at width n); 0 where every row fits one tile. None where the
program keeps no such counter (one from before it)."""

from perfbench import spans


def read(ctx):
    p = spans.read(ctx)
    if ctx.drive != "train_epoch" or p is None \
            or "spmm.tiled" not in p.counters:
        return None
    return p.counters["spmm.tiled"] / p.units
