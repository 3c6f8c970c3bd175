"""rlap_round_ms (ms): the mean length of the program's `rlap.round` spans
(one iteration of `ops/rlap.py`'s round loop, its end test's read-back
included) over the stretch `perfbench/spans.py` profiles."""

from perfbench import spans


def read(ctx):
    p = spans.read(ctx)
    rounds = [] if p is None else p.trace.named("rlap.round")
    if not rounds:
        return None
    return sum(b - a for a, b in rounds) / len(rounds) / 1e3
