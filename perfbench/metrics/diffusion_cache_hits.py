"""diffusion_cache_hits (fraction): the calls a cached diffusion view
answered from its cache, over all its calls: the program's counters
`diffusion.cache_hits` (`augment/base.py::CachedAugmentor`) over
`diffusion.builds` plus `diffusion.cache_hits`
(`augment/diffusion.py`), kept over the stretch `perfbench/spans.py`
profiles. 0.98 for a view made afresh once in 50 calls."""

from perfbench import spans


def read(ctx):
    p = spans.read(ctx)
    if p is None:
        return None
    hits = p.counters.get("diffusion.cache_hits", 0.0)
    calls = p.counters.get("diffusion.builds", 0.0) + hits
    return hits / calls if calls else None
