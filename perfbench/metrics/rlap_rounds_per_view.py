"""rlap_rounds_per_view (count): the elimination rounds per rLap view, from
the program's counters `rlap.rounds` / `rlap.views` (`ops/rlap.py`), kept
over the stretch `perfbench/spans.py` profiles."""

from perfbench import spans


def read(ctx):
    p = spans.read(ctx)
    if p is None or not p.counters.get("rlap.views"):
        return None
    return p.counters.get("rlap.rounds", 0.0) / p.counters["rlap.views"]
