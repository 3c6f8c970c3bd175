"""spmm_padding_share.train (%): the share of the slots `spmm` gathers
that are padding edges, all reading the sentinel row: 100 x the program's
counters `spmm.padding` / `spmm.slots` (`ops/spmm.py`), over the training
steps `perfbench/spans.py` profiles."""

from perfbench import spans


def read(ctx):
    p = spans.read(ctx)
    if ctx.drive != "train_epoch" or p is None \
            or not p.counters.get("spmm.slots"):
        return None
    return 100.0 * p.counters.get("spmm.padding", 0.0) \
        / p.counters["spmm.slots"]
