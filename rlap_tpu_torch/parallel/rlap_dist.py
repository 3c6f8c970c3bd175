"""Distributed rLap: the randomized Schur complement of an
edge-partitioned graph across the ranks of a mesh axis (counterpart of
`rlap_tpu/parallel/rlap_dist.py`).

It ports the semantics of the JAX kernel, not its static shapes, as
`ops/rlap.py` does for the single-device kernel. Edges are partitioned by
sender block (`partition.py`), so for any vertex i the whole column
(i, *) lives on owner(i):

* **Selection is replicated.** Every rank draws the same permutation from
  the same key, as `ops/rlap.py::eliminate` draws it. With o_v="random" the priority is the position itself;
  otherwise it is (degree, position), the degree of an owned node exact
  on its owner (one scatter over the rank's own edges) and replicated by
  one `all_gather_into_tensor` of equal padded blocks. Each of the
  Luby sub-rounds takes the neighbour minima the same way. Integers only,
  so every rank computes the same independent set.
* **Elimination is rank-local.** Each rank groups its eliminated columns
  with one sort, merges duplicate copies, orders each column by weight
  with o_n "asc"/"desc", and runs the single-device kernel's sampler
  (`ops/rlap.py::_sample_clique`: the suffix-CDF draw, or coarsen's
  race) on uniforms from `fold_in(round_key, rank)`. The mirror copies
  (j, i) of an eliminated i die where they are: the eliminated set is
  replicated.
* **Emissions are routed.** A clique edge (j, k) belongs on owner(j) and
  its mirror (k, j) on owner(k). After one exchange of the P counts,
  one `all_to_all_single` with variable split sizes carries every
  record (sender, receiver, float64 weight bits) to its owner.
* **Duplicates stay** until the next round's grouping merges them; the
  output is not coalesced, as in the JAX package.

With int64 keys and split sizes taken from the counts there is no
capacity to overflow: `slack` and `max_escalations` are accepted for the
JAX signature and do nothing, and the overflow flag is always False. Each
round syncs with the host twice: to size the exchange and to test for the
end.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from rlap_tpu_torch.core import rng
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.ops.rlap import (_BIG, _SUBITERS, _cap_to_budget, _check,
                                     _sample_clique)
from rlap_tpu_torch.parallel.mesh import axis_rank
from rlap_tpu_torch.parallel.partition import node_block_owner


def _gather_blocks(part: torch.Tensor, n: int, group) -> torch.Tensor:
    """The ranks' equal blocks concatenated in rank order, cut to n."""
    size = dist.get_world_size(group)
    out = part.new_empty(size * part.shape[0])
    dist.all_gather_into_tensor(out, part.contiguous(), group=group)
    return out[:n]


def _route(s, r, w, dest, size: int, group):
    """Send each record (s, r, w) to rank `dest`; returns what this rank
    received, in rank order."""
    order = torch.argsort(dest, stable=True)
    send = torch.stack([s[order], r[order],
                        w[order].double().view(torch.int64)], 1)
    counts = torch.bincount(dest, minlength=size)
    recv_counts = torch.empty_like(counts)
    dist.all_to_all_single(recv_counts, counts, group=group)
    recv = send.new_empty((int(recv_counts.sum()), 3))
    dist.all_to_all_single(recv, send, recv_counts.tolist(),
                           counts.tolist(), group=group)
    return recv[:, 0], recv[:, 1], recv[:, 2].view(torch.float64)


def _eliminate_local_rounds(s, r, w, key, t: int, n: int, mesh: DeviceMesh,
                            axis: str, o_v: str, o_n: str, subiters: int):
    """The round loop on one rank. s, r, w: the rank's live edges, every
    sender in its node block. Returns its final edges and the number of
    eliminated nodes."""
    dev = s.device
    group = mesh.get_group(axis)
    rank, size = axis_rank(mesh, axis)
    block = -(-n // size)
    lo = rank * block

    # the permutation is drawn as the single-device kernel draws it, so a
    # key eliminates the same nodes there and here (o_v="random")
    perm = torch.randperm(n, generator=key, device=dev)
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(n, device=dev)
    pending = pos < t if o_v == "random" else torch.ones(
        n, dtype=torch.bool, device=dev)
    removed, npend, rnd = 0, (t if o_v == "random" else n), 0
    big = n + 1
    while npend > 0 and removed < t:
        rkey = rng.fold_in(key, rnd)
        ukey = rng.fold_in(rkey, rank)
        s_blk = s - lo
        if o_v == "random":
            prio = pos
        else:
            deg = _gather_blocks(torch.bincount(s_blk, minlength=block),
                                 n, group)
            prio = deg * (n + 1) + pos

        # Luby sub-rounds: strict local minima among candidates, each
        # node's neighbour minimum exact on its owner, then gathered
        elim = torch.zeros_like(pending)
        sel = torch.zeros_like(pending)
        cand = pending
        for _ in range(max(1, subiters)):
            pack = torch.where(sel, torch.full_like(prio, -1),
                               torch.where(cand, prio,
                                           torch.full_like(prio, _BIG)))
            nmin_blk = torch.full((block,), _BIG, dtype=torch.int64,
                                  device=dev).scatter_reduce(
                                      0, s_blk, pack[r], "amin")
            nmin = _gather_blocks(nmin_blk, n, group)
            sel = cand & (prio < nmin) & (nmin >= 0)
            elim = elim | sel
            cand = cand & ~sel & (nmin >= 0)
        if o_v != "random":
            elim = _cap_to_budget(elim, prio, t - removed)

        # the rank's eliminated columns, duplicate copies merged
        es, er = elim[s], elim[r]
        owner, other, wt = s[es], r[es], w[es]
        keep = ~(es | er)
        s, r, w = s[keep], r[keep], w[keep]
        pair, inv = torch.unique(owner * big + other, sorted=True,
                                 return_inverse=True)
        v = torch.zeros(pair.shape[0], dtype=torch.float64,
                        device=dev).index_add_(0, inv, wt.double())
        owner, other = pair // big, pair % big
        if o_n in ("asc", "desc"):
            order = torch.argsort(v if o_n == "asc" else -v, stable=True)
            order = order[torch.argsort(owner[order], stable=True)]
            owner, other, v = owner[order], other[order], v[order]
        emit, partner, wnew = _sample_clique(owner, other, v, o_v, ukey)
        other, partner, wnew = other[emit], partner[emit], wnew[emit]

        # (other, partner) to owner(other), (partner, other) to
        # owner(partner)
        e_s = torch.cat([other, partner])
        e_r = torch.cat([partner, other])
        e_w = torch.cat([wnew, wnew]).to(w.dtype)
        dest = node_block_owner(e_s, n, size)
        rs, rr, rw = _route(e_s, e_r, e_w, dest, size, group)
        s = torch.cat([s, rs])
        r = torch.cat([r, rr])
        w = torch.cat([w, rw.to(w.dtype)])

        pending = pending & ~elim
        nelim, npend = torch.stack([elim.sum(), pending.sum()]).tolist()
        removed += nelim
        rnd += 1
    return s, r, w, removed


def eliminate_sharded(g: Graph, key: torch.Generator, num_remove,
                      mesh: DeviceMesh, axis: str = "data",
                      o_v: str = "random", o_n: str = "random",
                      subiters: int = _SUBITERS, slack: int = 2,
                      max_escalations: int = 0
                      ) -> Tuple[Graph, int, bool]:
    """The sharded `eliminate` (every o_v x o_n mode of the single-device
    kernel). `g` is this rank's shard of a graph arranged by
    `partition_edges_by_sender(g, axis size)`: every live sender lies in
    the rank's node block (checked). `key` must be the same on every rank
    and live on the graph's device.

    Returns (this rank's shard of the Schur complement, removed count,
    overflow flag). The shard keeps the sender-block arrangement and the
    input's capacity at least, and is NOT coalesced: duplicate copies of a
    surviving edge may remain (coalesce it shard-locally; SpMM adds them
    anyway). `slack` and `max_escalations` do nothing here (no static
    capacity), and the overflow flag is always False.
    """
    del slack, max_escalations  # no static capacity to grow
    _check(o_v, o_n, "fast", "independent")
    if o_v == "coarsen":
        o_n = "random"  # the coarsening preconditioner forces o_n
    n = g.num_nodes
    rank, size = axis_rank(mesh, axis)
    live = g.edge_mask
    s, r, w = g.senders[live], g.receivers[live], g.weights[live]
    if bool((node_block_owner(s, n, size) != rank).any()):
        raise ValueError(
            f"rank {rank} holds edges whose sender is outside its node "
            "block: pass its shard of partition_edges_by_sender(g, "
            f"{size})")
    # self-loops take no part in a Laplacian, zero weights are padding
    keep = (s != r) & (w != 0)
    s, r, w = s[keep], r[keep], w[keep]
    t = min(int(num_remove), n - 1)
    s, r, w, removed = _eliminate_local_rounds(
        s, r, w, key, t, n, mesh, axis, o_v, o_n, subiters)
    cap = max(g.edge_capacity, s.shape[0])
    pad = cap - s.shape[0]
    fill = torch.full((pad,), n, dtype=s.dtype, device=s.device)
    out = g.replace(senders=torch.cat([s, fill]),
                    receivers=torch.cat([r, fill]),
                    weights=torch.cat([w, w.new_zeros(pad)]))
    return out, removed, False
