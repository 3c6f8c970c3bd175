"""rlap_readbacks_per_round (count): the device-to-host copies (`Memcpy
DtoH` events: a boolean mask's count, `unique`, `nonzero`, the end test's
`.tolist()`) launched inside the program's `rlap.round` spans, over the
number of those spans, in the stretch `perfbench/spans.py` profiles. None
where the trace holds no device event (the CPU)."""

from perfbench import spans


def read(ctx):
    p = spans.read(ctx)
    if p is None or not p.trace.device:
        return None
    rounds = p.trace.named("rlap.round")
    if not rounds:
        return None
    copies = [e for e in p.trace.launched_in("rlap.round")
              if e[2].startswith("Memcpy DtoH")]
    return len(copies) / len(rounds)
