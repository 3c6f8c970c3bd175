"""diffusion_build_ms (ms): the mean length of the program's
`diffusion.build` spans (one diffusion view made afresh: rLap, the PPR
series and the top-k, `augment/diffusion.py`) over the stretch
`perfbench/spans.py` profiles. None where the stretch holds no build (a
program without the span)."""

from perfbench import spans


def read(ctx):
    p = spans.read(ctx)
    builds = [] if p is None else p.trace.named("diffusion.build")
    if not builds:
        return None
    return sum(b - a for a, b in builds) / len(builds) / 1e3
