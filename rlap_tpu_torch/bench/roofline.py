"""Speed-of-light (roofline) model of the rLap elimination, priced at the
card's own primitive costs.

Counterpart of `rlap_tpu/bench/roofline.py`. The round is made of random
gathers, scatter-mins, sorts and scans, so its floor cannot come from
FLOPs or bytes alone: `simulate` replays the round dynamics in numpy and
prices every operation of the round body at exactly the elements it must
touch, at a price a primitive costs per element. `roofline_fraction =
model / measured` (printed by `bench/rlap_throughput.py`) says how close
`ops/rlap.py::eliminate` gets to that floor on the same work.

The model is a floor at the primitives' rates as measured today, not a
physical ceiling: the sort is priced at `torch.sort`'s 64-bit radix sort,
the scan at `cumsum`, the gather at C1 `take` on an int32 table. A round
kernel that does the same element work by cheaper means (a sort of only
the key bits in use, a pool held on-chip) can beat a price; that price
is then to be measured again from the faster primitive, and the model
with it.

The replay is the JAX package's with its XLA scaffolding taken out, as the
port's `_eliminate_pool` has none: no stage prefixes, no touched-edge
budget and no trim, so every node the selection picks is eliminated; the
selection runs the port's `_SUBITERS` sub-rounds; the pool keys are
int64, so the pool sort is priced at 3 arrays at every n. Its numpy
stream is the JAX replay's (`default_rng(seed)`, `permutation`, one
`random` draw a round) on the same BA graph, so where the JAX replay
trims no round the two give the same rounds and prices. The replay's
stream is not the kernel's; its counts are representative of a run, and
its round count lands within a few of `eliminate`'s.

Per round (ACT = pool slots with a pending endpoint, C1 = slots with both
pending, T = slots touched by the eliminated nodes):

    pool sort            ACT slots x 3 arrays
    Luby selection       _SUBITERS x (gather + scatter-min) x 2*C1
    es / er lookup       gather ACT + C1
    run/suffix scans     6 scans x T
    partner lookup       sort 2T x 3 arrays + 2 scans x T
    classify/orient      gather 2T
    degree update        scatter 4T
    class pack           sort T x 4 arrays
    bookkeeping          ACT elementwise

Entry (fold sort, class sort, initial degrees, pending gathers) and exit
(unfold) are priced once, as in the JAX replay.

The prices hold no constant: `measure_prices` measures them on the card,
each as a rate apart from its launch's fixed part, the gather through the
port's C1 kernel (`ops.access.take`) and the scatter through its C4
kernels (`ops.access.scatter_min`), both held bit-equal to their plain
versions first.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.bench import probe_access as P
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.ops import access as A
from rlap_tpu_torch.ops.rlap import _SUBITERS

PRICES = ("gather", "scatter", "sort_arr", "scan", "elem")
_CATEGORIES = ("sort", "selection", "esr", "scans", "lookup", "classify",
               "degree", "pack", "book")
_POOL_SORT_ARRAYS = 3  # int64 keys: no packed / unpacked split
_MAX_ROUNDS = 200


def _unique(x: np.ndarray) -> np.ndarray:
    """`np.unique` of int64 `x` by a sort: from numpy 2.3 `np.unique`
    hashes instead, ~100x slower on the replay's 1.6M keys."""
    x = np.sort(x)
    keep = np.ones(x.shape[0], bool)
    keep[1:] = x[1:] != x[:-1]
    return x[keep]


def simulate(g: Graph, frac: float = 0.5, seed: int = 0, *,
             prices: Dict[str, float]) -> Dict:
    """Replay the rounds on `g` (the bench's BA(n, m) graph, on any
    device), t = frac * n, o_v = o_n = "random" (the bench
    configuration), priced at `prices` (ns per element, the keys of
    `PRICES`). Returns `model_ms`, `rounds`, `entry_exit_ms`,
    `breakdown_ms`, `removed` and the per-round counts `hist`, as the JAX
    replay does, and `elements` and `by_price_ms`: the elements each
    primitive of `PRICES` handles in all, entry and exit included, and
    their ms at its price."""
    missing = set(PRICES) - set(prices)
    if missing:
        raise ValueError(f"prices lack {sorted(missing)}")
    n = g.num_nodes
    e_cap = int(g.senders.shape[0])
    e_half = max(e_cap // 2, 1)
    mask = g.edge_mask.cpu().numpy()
    s_all = g.senders.cpu().numpy()[mask]
    r_all = g.receivers.cpu().numpy()[mask]
    keep = s_all < r_all
    s, r = s_all[keep], r_all[keep]

    t = int(frac * n)
    rng = np.random.default_rng(seed)
    pos = rng.permutation(n)
    pending = pos < t

    # elements of each category of the round body, by primitive
    counts = {c: dict.fromkeys(PRICES, 0) for c in _CATEGORIES}
    entry_exit = {"sort_arr": 3 * e_cap + 3 * e_half, "scatter": 2 * e_half,
                  "gather": 2 * e_half, "elem": e_cap}

    rounds = 0
    hist = []
    big = np.iinfo(np.int64).max
    while pending.any() and rounds < _MAX_ROUNDS:
        deg = np.bincount(s, minlength=n) + np.bincount(r, minlength=n)
        ps, pr = pending[s], pending[r]
        act = int((ps | pr).sum())
        c1 = int((ps & pr).sum())

        # Luby sub-rounds on (deg, pos) minima among pending neighbours
        prio = deg.astype(np.int64) * (n + 1) + pos
        elim = np.zeros(n, bool)
        cand = pending.copy()
        for _ in range(_SUBITERS):
            pack = np.where(elim, -1, np.where(cand, prio, big))
            nmin = np.full(n, big)
            np.minimum.at(nmin, s, pack[r])
            np.minimum.at(nmin, r, pack[s])
            new = cand & (prio < nmin) & (nmin >= 0)
            elim |= new
            cand &= ~new & (nmin >= 0)

        es, er = elim[s], elim[r]
        touched = es | er
        tt = int(touched.sum())

        for cat, parts in (
                ("sort", {"sort_arr": _POOL_SORT_ARRAYS * act}),
                ("selection", {"gather": _SUBITERS * 2 * c1,
                               "scatter": _SUBITERS * 2 * c1}),
                ("esr", {"gather": act + c1}),
                ("scans", {"scan": 6 * tt}),
                ("lookup", {"sort_arr": 3 * 2 * tt, "scan": 2 * tt}),
                ("classify", {"gather": 2 * tt}),
                ("degree", {"scatter": 4 * tt}),
                ("pack", {"sort_arr": 4 * tt}),
                ("book", {"elem": act})):
            for k, v in parts.items():
                counts[cat][k] += v
        hist.append(dict(rnd=rounds, ACT=act, C1=c1, T=tt,
                         elim=int(elim.sum())))

        # drop the touched slots; each column emits d - 1 clique edges to
        # partners drawn from its suffix (weights do not change counts)
        tsel = np.nonzero(touched)[0]
        owners = np.where(elim[s[tsel]], s[tsel], r[tsel])
        others = np.where(elim[s[tsel]], r[tsel], s[tsel])
        okey = _unique(owners * np.int64(n + 1) + others)
        owners = okey // (n + 1)
        others = okey - owners * (n + 1)
        cols = _unique(owners)
        seg_id = np.searchsorted(cols, owners)
        seg_start = np.searchsorted(owners, cols)[seg_id]
        j = np.arange(len(owners)) - seg_start
        d = np.bincount(seg_id)[seg_id]
        emit = j < d - 1
        u = rng.random(len(owners))
        pidx = np.minimum(j + 1 + np.floor(u * (d - 1 - j)).astype(np.int64),
                          d - 1)
        partner = others[seg_start + pidx]
        a = np.minimum(others, partner)[emit]
        b = np.maximum(others, partner)[emit]

        key = _unique(np.concatenate([s[~touched], a]) * np.int64(n + 1)
                        + np.concatenate([r[~touched], b]))
        s = key // (n + 1)
        r = key - s * (n + 1)

        pending &= ~elim
        rounds += 1

    def ms(elements: Dict[str, int]) -> float:
        return sum(prices[k] * v for k, v in elements.items()) / 1e6

    elements = {k: entry_exit.get(k, 0) + sum(c[k] for c in counts.values())
                for k in PRICES}
    breakdown = {c: ms(v) for c, v in counts.items()}
    entry_exit_ms = ms(entry_exit)
    return dict(model_ms=sum(breakdown.values()) + entry_exit_ms,
                rounds=rounds, entry_exit_ms=entry_exit_ms,
                breakdown_ms=breakdown,
                removed=int(t - pending.sum()) if pending.any() else t,
                hist=hist, elements=elements,
                by_price_ms={k: prices[k] * v / 1e6
                             for k, v in elements.items()})


def roofline_ms(g: Graph, frac: float = 0.5, seed: int = 0, *,
                prices: Dict[str, float]) -> Tuple[float, Dict]:
    res = simulate(g, frac=frac, seed=seed, prices=prices)
    return res["model_ms"], res


def _sort3(keys, p1, p2):
    """The pool sort's unit: E int64 keys and two payload gathers (the
    probe's D1)."""
    srt, order = torch.sort(keys)
    return srt, p1[order], p2[order]


def measure_prices(device=None, n: int = 100_000, e: int = 1_600_000,
                   reps: int = 10) -> Dict:
    """The ns per element of each primitive of `PRICES` on `device` (the
    card by default), each as a rate: (t(2E) - t(E)) / E, with
    2 t(E) - t(2E), the part a launch costs whatever its size, returned
    apart. Each of `reps` timed calls works on its own draw.

    gather: C1 `take` on an int32 table of n and random int32 indices;
    scatter: C4 `scatter_min` into a table of n; sort_arr: `torch.sort` of
    E int64 keys and two int64 payload gathers, over 3 arrays; scan:
    `torch.cumsum` over E int64; elem: one elementwise pass over E int64.
    `take` and `scatter_min` are held bit-equal to their plain versions at
    E and at 2E before they are timed (`probe_access.hold`); the times are
    `probe_access.time_ms`'s. On the CPU the same code runs the plain
    versions on the host clock, and its prices say nothing about the card
    (the host's noise can even make one negative)."""
    dev = resolve_device(device)
    if n <= 0 or e <= 0 or reps <= 0:
        raise ValueError(f"need n, E and reps > 0, got {n} {e} {reps}")
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(high):
        return torch.randint(0, high, (2 * e,), generator=gen, device=dev,
                             dtype=torch.int32)

    table = torch.randint(0, 1 << 30, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    sets = []
    for _ in range(reps + 1):
        idx, val = draw(n), draw(1 << 20)
        keys = idx.long() * (n + 1) + draw(n).long()  # the pool's keys
        sets.append((idx, val, keys, idx.long(), val.long()))

    def args(name: str, k: int) -> list:
        """Each set's arguments of primitive `name` on its first k."""
        out = []
        for idx, val, keys, p1, p2 in sets:
            out.append({"gather": (table, idx[:k]),
                        "scatter": (idx[:k], val[:k], n),
                        "sort_arr": (keys[:k], p1[:k], p2[:k]),
                        "scan": (keys[:k],),
                        "elem": (keys[:k],)}[name])
        return out

    fns = {"gather": A.take, "scatter": A.scatter_min, "sort_arr": _sort3,
           "scan": lambda x: torch.cumsum(x, 0), "elem": lambda x: x + 1}
    arrays = {"sort_arr": 3}
    before = {k: A.launch_counts[k] for k in ("take", "scatter_min")}
    errs = {}
    for name, kname, plain in (("gather", "take", A.take_plain),
                               ("scatter", "scatter_min",
                                A.scatter_min_plain)):
        errs[kname] = max(P.hold(kname, fns[name], plain, args(name, k)[0],
                                 f" at E={k}") for k in (e, 2 * e))
    ms, ms_twice, price, fixed = {}, {}, {}, {}
    for name in PRICES:
        ms[name] = P.time_ms(fns[name], args(name, e))
        ms_twice[name] = P.time_ms(fns[name], args(name, 2 * e))
        added, fixed[name] = P.rate_parts(ms[name], ms_twice[name])
        price[name] = 1e6 * added / (e * arrays.get(name, 1))
    return {"device": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "timer": "cuda events" if on_card else "host clock",
            "n": n, "e": e, "reps": reps, "prices_ns": price,
            "fixed_ms": fixed, "ms": ms, "ms_twice": ms_twice,
            "max_abs_err": errs,
            "launches": {k: A.launch_counts[k] - v
                         for k, v in before.items()}}
