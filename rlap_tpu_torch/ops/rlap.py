"""Randomized Schur-complement elimination (rLap), in plain PyTorch.

Counterpart of `rlap_tpu/ops/rlap.py`. It ports the semantics of
`_eliminate_impl_fast`, not its XLA scaffolding: eager PyTorch has dynamic
shapes and int64 keys, so a round works on the live edges it touches and
there are no staged prefixes, level ladders, touched-edge budgets or int32
key packing. With no static budget `eliminate` cannot overflow, and the
overflow escalation of the JAX `approximate_cholesky` has nothing to do.

The algorithm, as in the JAX package:

* **Entry.** Remove self-loops, coalesce, drop zero weights, cap t at n-1
  (the reference never eliminates the last vertex), and fold the
  symmetric directed edges into a canonical pool of one u < v edge per
  undirected pair. The pool may hold duplicate copies of a pair; they are
  merged when one of their endpoints is eliminated.
* **Elimination set.** A uniform permutation gives each node a position.
  With o_v="random" the pending set is the first t positions; with
  "degree" and "coarsen" every node is pending and each round is capped
  at the remaining budget, lowest priority first.
* **Rounds over independent sets.** A round eliminates strict local minima
  of prio = (degree, position) among pending neighbours
  (schedule="fast"), or of the position alone ("luby"), found by three
  scatter-min sub-rounds. Members of an independent set never read each
  other's writes, so a round samples what sequential elimination would.
  Degrees count duplicate copies and are recomputed from the pool each
  round.
* **Per round.** Touched edges are grouped by (eliminated owner, other)
  and duplicate runs merged. With o_n "asc"/"desc" each column is ordered
  by weight ("random" keeps the other-id order, as the JAX package does;
  the sampler is unbiased for any fixed order). "coarsen" forces
  o_n="random".
* **Suffix-CDF sampler.** With column weights v_j, prefix sums cum_j, total
  csum and suffix S_j = csum - cum_j, neighbour j emits one clique edge of
  weight v_j S_j / csum to a partner drawn from the suffix with
  probability v_m / S_j: the first m with cum_m > cum_j + u S_j.
* **race sampler.** `sampler="race"` draws one exponential race key per
  neighbour, -log(u) / v, and gives neighbour j the race's winner among
  the later slots of its column: the same marginal v_m / S_j, from one
  draw per slot and no search. The draws of one column share keys and are
  positively correlated, which inflates the output's largest singular
  value by about 20% on BA graphs (the JAX package's behaviour, its
  `ops/rlap.py:875-881`): `independent` stays the default.
* **coarsen.** One partner per column by an exponential race; every other
  neighbour is rewired onto it with the harmonic weight v w / (v + w).
* **Write-back.** Emitted edges are canonicalised (min, max) and appended;
  touched edges retire. The exit unfolds the pool to symmetric directed
  COO and coalesces.

Precision: the partner draw is one `torch.searchsorted` over a global
float64 running sum of the column weights, with each query clamped below
its column's end (the JAX `nextafter` clamp). A global running sum
subtracts large totals; the JAX package avoids that in float32 with a
segmented scan. In float64 the absolute error is about 1e-16 times the
pool's total weight, far below any column weight of a real graph.

The round loop syncs with the host once per round to test for the end.

Tracing (`utils/tracing.py`, kept only while a profiler records): a span
`rlap.eliminate` for each view, holding `rlap.entry` (for
`eliminate_pair` outside it: the two views share the entry), one
`rlap.round` for each round and `rlap.exit`; each round holds its
stages `rlap.select`, `rlap.merge`, `rlap.sample`, `rlap.writeback` and
`rlap.end_test` (the read-back of the end test). The counters
`rlap.views` and `rlap.rounds` count the views and their rounds.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.utils import tracing

_VALID_O_V = ("random", "degree", "coarsen")
_VALID_O_N = ("asc", "desc", "random")
_VALID_SCHEDULE = ("fast", "luby")
_VALID_SAMPLER = ("independent", "race")
_BIG = torch.iinfo(torch.int64).max
_SUBITERS = 3  # the JAX package's default `subiters`


def _select(s, r, pending, prio) -> torch.Tensor:
    """Strict local minima of `prio` among pending nodes, over `_SUBITERS`
    scatter-min sub-rounds. Only edges with both endpoints pending can
    block, so only those are scanned."""
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


def _cap_to_budget(elim, prio, remaining: int) -> torch.Tensor:
    """Keep the `remaining` lowest-priority members of the set (the
    priority-queue pop order)."""
    n = elim.shape[0]
    ranked = torch.sort(torch.where(elim, prio, torch.full_like(prio, _BIG)))
    kth = ranked.values[min(remaining, n) - 1]
    return elim & (prio <= kth)


def _race_keys(v, gen) -> torch.Tensor:
    u = torch.rand(v.shape[0], generator=gen, device=v.device,
                   dtype=torch.float64)
    return -torch.log(u.clamp_min(1e-12)) / v.clamp_min(1e-30)


def _suffix_winner(race, col) -> torch.Tensor:
    """For each slot k, the slot with the smallest race key among slots
    >= k of the same column (the JAX `_segmented_race_rev`). The keys are
    replaced by their global ranks and offset by the column, so that one
    reversed running minimum never looks past a column's end."""
    m = race.shape[0]
    rank = torch.empty(m, dtype=torch.int64, device=race.device)
    rank[torch.argsort(race)] = torch.arange(m, device=race.device)
    winner = torch.cummin((col * m + rank).flip(0), 0).indices
    return (m - 1 - winner).flip(0)


def _sample_clique(owner, other, v, o_v: str, gen,
                   sampler: str = "independent"):
    """Per eliminated column (runs of equal `owner`, already ordered): the
    emitted clique edges as (emit mask, partner, weight float64)."""
    m = owner.shape[0]
    dev = owner.device
    if m == 0:  # every node of the round had no edge: nothing to sample
        return torch.zeros(0, dtype=torch.bool, device=dev), other, v
    head = torch.ones(m, dtype=torch.bool, device=dev)
    head[1:] = owner[1:] != owner[:-1]
    col = torch.cumsum(head.long(), 0) - 1
    starts = torch.nonzero(head).flatten()
    ends = torch.cat([starts[1:] - 1,
                      torch.tensor([m - 1], device=dev)])
    gsum = torch.cumsum(v, 0)  # float64, globally monotone
    base = (gsum - v)[starts]
    cum = gsum - base[col]
    csum = (gsum[ends] - base)[col]
    if o_v == "coarsen":
        race = _race_keys(v, gen)
        ncol = starts.shape[0]
        fastest = torch.full((ncol,), float("inf"), dtype=race.dtype,
                             device=dev).scatter_reduce(0, col, race, "amin")
        idx = torch.arange(m, device=dev)
        first = torch.full((ncol,), m, dtype=torch.int64, device=dev)
        first = first.scatter_reduce(
            0, col, torch.where(race == fastest[col], idx,
                                torch.full_like(idx, m)), "amin")
        partner = other[first[col]]
        w_k = v[first[col]]
        emit = (csum > 0) & (other != partner)
        wnew = v * w_k / torch.where(v + w_k > 0, v + w_k,
                                     torch.ones_like(v))
        return emit, partner, wnew
    suffix = csum - cum
    emit = suffix > 0
    wnew = v * suffix / torch.where(csum > 0, csum, torch.ones_like(csum))
    if sampler == "race":
        winner = _suffix_winner(_race_keys(v, gen), col)
        # slot j's partner is the winner among the slots after it; the
        # last slot of a column emits nothing
        after = torch.cat([winner[1:], winner[-1:]])
        return emit, other[after], wnew
    u = torch.rand(m, generator=gen, device=dev, dtype=torch.float64)
    g_end = gsum[ends][col]
    query = torch.minimum(gsum + u * suffix,
                          torch.nextafter(g_end, torch.zeros_like(g_end)))
    k = torch.searchsorted(gsum, query, right=True)
    k = torch.minimum(torch.maximum(k, torch.arange(1, m + 1, device=dev)),
                      ends[col])
    return emit, other[k], wnew


def _eliminate_pool(s, r, w, gen, t: int, n: int, o_v: str, o_n: str,
                    schedule: str, sampler: str = "independent"):
    """Eliminate on a canonical pool (s < r). Returns the final pool, the
    number of eliminated nodes and the number of rounds."""
    dev = s.device
    if o_v == "coarsen":
        o_n = "random"
    perm = torch.randperm(n, generator=gen, device=dev)
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(n, device=dev)
    pending = pos < t if o_v == "random" else torch.ones(
        n, dtype=torch.bool, device=dev)
    removed, npend, rounds = 0, (t if o_v == "random" else n), 0
    big = n + 1
    while npend > 0 and removed < t:
        with tracing.annotate("rlap.round"):
            with tracing.annotate("rlap.select"):
                deg = torch.bincount(torch.cat([s, r]), minlength=n)
                if o_v == "random" and schedule == "luby":
                    prio = pos
                else:
                    prio = deg * (n + 1) + pos
                elim = _select(s, r, pending, prio)
                if o_v != "random":
                    elim = _cap_to_budget(elim, prio, t - removed)

            with tracing.annotate("rlap.merge"):
                es, er = elim[s], elim[r]
                touched = es | er
                owner = torch.where(es, s, r)[touched]
                other = torch.where(es, r, s)[touched]
                wt = w[touched]
                keep = ~touched
                s, r, w = s[keep], r[keep], w[keep]

                # merge duplicate copies: runs of one (owner, other) pair
                pair, inv = torch.unique(owner * big + other, sorted=True,
                                         return_inverse=True)
                v = torch.zeros(pair.shape[0], dtype=torch.float64,
                                device=dev).index_add_(0, inv, wt.double())
                owner, other = pair // big, pair % big
                if o_n in ("asc", "desc"):
                    order = torch.argsort(v if o_n == "asc" else -v,
                                          stable=True)
                    order = order[torch.argsort(owner[order], stable=True)]
                    owner, other, v = owner[order], other[order], v[order]

            with tracing.annotate("rlap.sample"):
                emit, partner, wnew = _sample_clique(owner, other, v, o_v,
                                                     gen, sampler)
            with tracing.annotate("rlap.writeback"):
                other, partner = other[emit], partner[emit]
                s = torch.cat([s, torch.minimum(other, partner)])
                r = torch.cat([r, torch.maximum(other, partner)])
                w = torch.cat([w, wnew[emit].to(w.dtype)])

            with tracing.annotate("rlap.end_test"):
                pending = pending & ~elim
                nelim, npend = torch.stack([elim.sum(),
                                            pending.sum()]).tolist()
        removed += nelim
        rounds += 1
    tracing.count("rlap.views", 1)
    tracing.count("rlap.rounds", rounds)
    return s, r, w, removed, rounds


def _entry(g: Graph, num_remove: int):
    with tracing.annotate("rlap.entry"):
        gg = G.drop_zero_weight(G.coalesce_fast(G.remove_self_loops(g)))
        t = min(int(num_remove), g.num_nodes - 1)
        canon = (gg.senders < gg.num_nodes) & (gg.senders < gg.receivers)
        return gg.senders[canon], gg.receivers[canon], gg.weights[canon], t


def _exit(g: Graph, s, r, w) -> Graph:
    with tracing.annotate("rlap.exit"):
        out = g.replace(senders=torch.cat([s, r]),
                        receivers=torch.cat([r, s]),
                        weights=torch.cat([w, w]))
        out = G.with_capacity(out, max(g.edge_capacity, 2 * s.shape[0]))
        return G.drop_zero_weight(G.coalesce_fast(out))


def _check(o_v: str, o_n: str, schedule: str, sampler: str):
    if o_v not in _VALID_O_V:
        raise ValueError(f"o_v must be one of {_VALID_O_V}, got {o_v!r}")
    if o_n not in _VALID_O_N:
        raise ValueError(f"o_n must be one of {_VALID_O_N}, got {o_n!r}")
    if schedule not in _VALID_SCHEDULE:
        raise ValueError(
            f"schedule must be one of {_VALID_SCHEDULE}, got {schedule!r}")
    if sampler not in _VALID_SAMPLER:
        raise ValueError(
            f"sampler must be one of {_VALID_SAMPLER}, got {sampler!r}")


def eliminate(g: Graph, key: torch.Generator, num_remove: int,
              o_v: str = "random", o_n: str = "random",
              schedule: str = "fast",
              sampler: str = "independent") -> Tuple[Graph, int, int]:
    """Eliminate `num_remove` nodes of `g` on its own device.

    Returns (schur_graph, removed_count, rounds). `key` must live on the
    graph's device. The output keeps the input's edge capacity.
    `sampler="race"` trades spectral fidelity for one draw per slot (see
    the module docstring); use it only where that does not matter.
    """
    _check(o_v, o_n, schedule, sampler)
    with tracing.annotate("rlap.eliminate"):
        s, r, w, t = _entry(g, num_remove)
        s, r, w, removed, rounds = _eliminate_pool(
            s, r, w, key, t, g.num_nodes, o_v, o_n, schedule, sampler)
        return _exit(g, s, r, w), removed, rounds


def eliminate_pair(g: Graph, key: torch.Generator, num_remove: int,
                   o_v: str = "random", o_n: str = "random",
                   schedule: str = "fast", sampler: str = "independent"):
    """Two independent rLap views of one graph, sharing the entry
    canonicalisation. View i equals `eliminate(g, split(key)[i], ...)`.

    Returns ((g1, removed1, rounds1), (g2, removed2, rounds2)).
    """
    _check(o_v, o_n, schedule, sampler)
    s, r, w, t = _entry(g, num_remove)
    outs = []
    for kv in rng.split(key):
        with tracing.annotate("rlap.eliminate"):
            so, ro, wo, removed, rounds = _eliminate_pool(
                s, r, w, kv, t, g.num_nodes, o_v, o_n, schedule, sampler)
            outs.append((_exit(g, so, ro, wo), removed, rounds))
    return tuple(outs)


def approximate_cholesky(g: Graph, key: torch.Generator, num_remove: int,
                         o_v: str = "random", o_n: str = "random",
                         schedule: str = "fast", device=None,
                         sampler: str = "independent") -> Graph:
    """A randomized Schur complement of `g` after removing `num_remove`
    vertices, graph in and graph out, computed on `device` (the card by
    default; `key` must live there). The JAX package's escalation re-run
    on overflow has no counterpart: this elimination has no budget to
    overflow."""
    _check(o_v, o_n, schedule, sampler)
    g = g.to(resolve_device(device))
    if int(num_remove) <= 0:
        return G.coalesce(G.drop_zero_weight(G.remove_self_loops(g)))
    return eliminate(g, key, num_remove, o_v=o_v, o_n=o_n,
                     schedule=schedule, sampler=sampler)[0]
