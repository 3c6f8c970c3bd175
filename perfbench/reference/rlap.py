"""rLap views, plain: a frozen copy of the program's randomized
Schur-complement elimination on the path the configurations run
(`o_v="random"`, `o_n="asc"`, the "fast" schedule, the independent
suffix-CDF sampler), written on edge lists alone.

It makes the same draws from the same key as the program: one
`randperm(n)`, then one `rand(m)` a round over the round's m merged
(eliminated, neighbour) pairs. So a sound program's view equals this one
edge for edge; a view that differs was sampled otherwise.

The algorithm (Kyng and Sachdeva's approximate Gaussian elimination,
sampled over independent sets): the first t positions of a uniform
permutation are eliminated, in rounds of strict local minima of (degree,
position) among pending neighbours; each eliminated node's merged column,
ordered by weight, gives neighbour j one edge to a partner drawn from the
later slots with probability v_m / S_j, of weight v_j S_j / csum. The view
is the remaining graph's edge set, weights set to one.
"""

from __future__ import annotations

import torch

from perfbench.reference import keys

_BIG = torch.iinfo(torch.int64).max
_SUBITERS = 3


def _select(s, r, pending, prio):
    n = pending.shape[0]
    both = pending[s] & pending[r]
    src = torch.cat([s[both], r[both]])
    dst = torch.cat([r[both], s[both]])
    big = torch.full((n,), _BIG, dtype=torch.int64, device=s.device)
    elim = torch.zeros_like(pending)
    sel = torch.zeros_like(pending)
    cand = pending
    for _ in range(_SUBITERS):
        pack = torch.where(sel, torch.full_like(prio, -1),
                           torch.where(cand, prio, big))
        nmin = big.scatter_reduce(0, src, pack[dst], "amin")
        sel = cand & (prio < nmin) & (nmin >= 0)
        elim = elim | sel
        cand = cand & ~sel & (nmin >= 0)
    return elim


def _sample(owner, other, v, gen, dt):
    """Per column (runs of one owner, ordered by weight): emit mask,
    partner and weight of each slot's clique edge."""
    m = owner.shape[0]
    dev = owner.device
    head = torch.ones(m, dtype=torch.bool, device=dev)
    head[1:] = owner[1:] != owner[:-1]
    col = torch.cumsum(head.long(), 0) - 1
    starts = torch.nonzero(head).flatten()
    ends = torch.cat([starts[1:] - 1, torch.tensor([m - 1], device=dev)])
    v = v.to(dt)
    gsum = torch.cumsum(v, 0)
    base = (gsum - v)[starts]
    cum = gsum - base[col]
    csum = (gsum[ends] - base)[col]
    suffix = csum - cum
    emit = suffix > 0
    wnew = v * suffix / torch.where(csum > 0, csum, torch.ones_like(csum))
    u = torch.rand(m, generator=gen, device=dev,
                   dtype=torch.float64).to(dt)
    g_end = gsum[ends][col]
    query = torch.minimum(gsum + u * suffix,
                          torch.nextafter(g_end, torch.zeros_like(g_end)))
    k = torch.searchsorted(gsum, query, right=True)
    k = torch.minimum(torch.maximum(k, torch.arange(1, m + 1, device=dev)),
                      ends[col])
    return emit, other[k], wnew


def schur_edges(senders, receivers, weights, n: int, num_remove: int,
                gen: torch.Generator, dt=torch.float64):
    """The live directed edges (sorted keys s * (n + 1) + r) of the rLap
    view of a graph given by its edge lists (padding where sender == n)."""
    dev = senders.device
    big = n + 1
    live = (senders < n) & (senders != receivers) & (weights != 0)
    key, inv = torch.unique(senders[live] * big + receivers[live],
                            return_inverse=True)
    w = torch.zeros(key.shape[0], dtype=weights.dtype,
                    device=dev).index_add_(0, inv, weights[live])
    s, r = key // big, key % big
    canon = (s < r) & (w != 0)
    s, r, w = s[canon], r[canon], w[canon]
    t = min(int(num_remove), n - 1)

    perm = torch.randperm(n, generator=gen, device=dev)
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(n, device=dev)
    pending = pos < t
    removed, npend = 0, t
    while npend > 0 and removed < t:
        deg = torch.bincount(torch.cat([s, r]), minlength=n)
        prio = deg * (n + 1) + pos
        elim = _select(s, r, pending, prio)
        es, er = elim[s], elim[r]
        touched = es | er
        owner = torch.where(es, s, r)[touched]
        other = torch.where(es, r, s)[touched]
        wt = w[touched]
        keep = ~touched
        s, r, w = s[keep], r[keep], w[keep]
        pair, inv = torch.unique(owner * big + other, sorted=True,
                                 return_inverse=True)
        v = torch.zeros(pair.shape[0], dtype=torch.float64,
                        device=dev).index_add_(0, inv, wt.double())
        owner, other = pair // big, pair % big
        order = torch.argsort(v, stable=True)
        order = order[torch.argsort(owner[order], stable=True)]
        owner, other, v = owner[order], other[order], v[order]
        if owner.shape[0] > 0:
            emit, partner, wnew = _sample(owner, other, v, gen, dt)
            other, partner = other[emit], partner[emit]
            s = torch.cat([s, torch.minimum(other, partner)])
            r = torch.cat([r, torch.maximum(other, partner)])
            w = torch.cat([w, wnew[emit].to(w.dtype)])
        pending = pending & ~elim
        nelim, npend = torch.stack([elim.sum(), pending.sum()]).tolist()
        removed += nelim
    both = torch.cat([s * big + r, r * big + s])
    wsum = torch.cat([w, w])
    key, inv = torch.unique(both, return_inverse=True)
    alive = torch.zeros(key.shape[0], dtype=torch.bool,
                        device=dev).index_fill_(0, inv[wsum != 0], True)
    return key[alive]


def masked_features(x: torch.Tensor, gen: torch.Generator, pf: float):
    """Whole feature columns zeroed with probability pf, one draw a
    column."""
    keep = torch.rand(x.shape[-1], generator=gen, device=x.device) >= pf
    return x * keep.to(x.dtype)[None, :]


def view(g, seed: int, frac: float, pf: float, plumbing: str,
         dt=torch.float64):
    """(live edge keys, features) of the view the program's augmentor
    makes from key `seed`. `plumbing` says how the augmentor hands its
    key to its two stages: "compose" (GRACE's `Compose([RLap, Feature
    Masking])`: stage i gets fold_in(key, i)) or "split" (CCA-SSG's
    `rlap_aug`: the two halves of split(key))."""
    if plumbing == "compose":
        k_top, k_feat = keys.fold_in(seed, 0), keys.fold_in(seed, 1)
    elif plumbing == "split":
        k_top, k_feat = keys.split(seed)
    else:
        raise ValueError(f"unknown key plumbing {plumbing!r}")
    dev = g["senders"].device
    edges = schur_edges(g["senders"], g["receivers"], g["weights"],
                        g["num_nodes"], int(frac * g["num_nodes"]),
                        keys.generator(k_top, dev), dt)
    return edges, masked_features(g["x"], keys.generator(k_feat, dev), pf)
