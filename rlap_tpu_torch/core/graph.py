"""Padded-COO graph container and edge-list algebra, in PyTorch.

Counterpart of `rlap_tpu/core/graph.py`, with the same conventions so that
arrays compare one to one with the JAX package:

* Padding edges have ``senders == receivers == num_nodes`` (a sentinel node)
  and ``weights == 0``. Segment reductions use ``num_nodes + 1`` segments
  and drop the last row.
* Graphs are directed at the storage level; an undirected graph stores both
  ``(u, v)`` and ``(v, u)``.
* The edge capacity is the length of the arrays, as given at construction.

Indices are int64 (torch's index type); compare with the JAX package's
int32 arrays by value. Eager PyTorch has dynamic shapes, so no function
here needs the JAX package's int32 key-packing bounds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rlap_tpu_torch import resolve_device


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Graph:
    """A padded COO graph of tensors on one device."""

    senders: torch.Tensor  # int64[edge_capacity]
    receivers: torch.Tensor  # int64[edge_capacity]
    weights: torch.Tensor  # float[edge_capacity]
    num_nodes: int
    x: Optional[torch.Tensor] = None  # [num_nodes, F] node features
    node_mask: Optional[torch.Tensor] = None  # bool[num_nodes]

    @property
    def device(self) -> torch.device:
        return self.senders.device

    @property
    def edge_capacity(self) -> int:
        return self.senders.shape[0]

    @property
    def edge_mask(self) -> torch.Tensor:
        return self.senders < self.num_nodes

    @property
    def num_edges(self) -> torch.Tensor:
        """Number of live (non-padding) edges, as a 0-d tensor."""
        return self.edge_mask.sum()

    @property
    def num_real_nodes(self) -> torch.Tensor:
        if self.node_mask is None:
            return torch.tensor(self.num_nodes, device=self.device)
        return self.node_mask.sum()

    def replace(self, **changes) -> "Graph":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "Graph":
        def mv(t):
            return None if t is None else t.to(device)
        return self.replace(senders=mv(self.senders),
                            receivers=mv(self.receivers),
                            weights=mv(self.weights), x=mv(self.x),
                            node_mask=mv(self.node_mask))

    @staticmethod
    def from_edges(senders, receivers, num_nodes: int, weights=None, x=None,
                   edge_capacity: Optional[int] = None,
                   dtype=torch.float32, device=None) -> "Graph":
        """Build from (possibly numpy) edge arrays, padding to capacity."""
        senders = np.asarray(senders)
        receivers = np.asarray(receivers)
        e = senders.shape[0]
        if weights is None:
            weights = np.ones((e,), dtype=np.float64)
        weights = np.asarray(weights)
        cap = edge_capacity or max(_round_up(max(e, 1), 128), 128)
        if e > cap:
            raise ValueError(f"edge_capacity {cap} < num edges {e}")
        s = np.full((cap,), num_nodes, np.int64)
        r = np.full((cap,), num_nodes, np.int64)
        w = np.zeros((cap,), np.float64)
        s[:e] = senders
        r[:e] = receivers
        w[:e] = weights
        dev = resolve_device(device)
        return Graph(
            senders=torch.as_tensor(s, device=dev),
            receivers=torch.as_tensor(r, device=dev),
            weights=torch.as_tensor(w, device=dev).to(dtype),
            num_nodes=int(num_nodes),
            x=None if x is None else torch.as_tensor(x, device=dev),
        )


def _where(mask, a, b):
    return torch.where(mask, a, torch.as_tensor(b, dtype=a.dtype,
                                                device=a.device))


def sort_edges(g: Graph) -> Graph:
    """Sort edges by (sender, receiver); padding goes to the tail."""
    key = g.senders * (g.num_nodes + 1) + g.receivers
    order = torch.argsort(key, stable=True)
    return g.replace(senders=g.senders[order], receivers=g.receivers[order],
                     weights=g.weights[order])


def coalesce(g: Graph, reduce: str = "sum") -> Graph:
    """Merge duplicate (sender, receiver) pairs, compacted to the front and
    sorted by (sender, receiver); padding at the tail. `reduce` is "sum" or
    "max" (the latter against a zero start, as the JAX package does)."""
    if reduce not in ("sum", "max"):
        raise ValueError(f"unknown reduce {reduce!r}")
    g = sort_edges(g)
    n, cap = g.num_nodes, g.edge_capacity
    s, r = g.senders, g.receivers
    head = torch.ones_like(s, dtype=torch.bool)
    head[1:] = (s[1:] != s[:-1]) | (r[1:] != r[:-1])
    pos = torch.cumsum(head.long(), 0) - 1
    zeros = torch.zeros((cap,), dtype=g.weights.dtype, device=g.device)
    if reduce == "sum":
        wsum = zeros.index_add(0, pos, g.weights)
    else:
        wsum = zeros.scatter_reduce(0, pos, g.weights, "amax")
    full = torch.full((cap,), n, dtype=s.dtype, device=g.device)
    snew = full.scatter_reduce(0, pos, s, "amin")
    rnew = full.scatter_reduce(0, pos, r, "amin")
    live = snew < n
    return g.replace(senders=_where(live, snew, n),
                     receivers=_where(live, rnew, n),
                     weights=_where(live, wsum, 0.0))


def coalesce_fast(g: Graph) -> Graph:
    """Merge duplicate pairs in place: one sort by the fused key
    sender*(n+1)+receiver, then the tail of each duplicate run keeps the sum
    and the rest become padding where they fell. Use where edge order does
    not matter. int64 keys hold any node count that fits memory, so there
    is no fallback to `coalesce` as in the JAX package (which needs
    n*(n+2) < 2^31)."""
    n = g.num_nodes
    big = n + 1
    kappa, order = torch.sort(g.senders * big + g.receivers, stable=True)
    w = g.weights[order]
    same = kappa[1:] == kappa[:-1]
    head = torch.ones_like(kappa, dtype=torch.bool)
    head[1:] = ~same
    tail = torch.ones_like(kappa, dtype=torch.bool)
    tail[:-1] = ~same
    run = torch.cumsum(head.long(), 0) - 1
    wsum = torch.zeros((kappa.shape[0],), dtype=w.dtype,
                       device=w.device).index_add(0, run, w)[run]
    keep = tail & (kappa < n * big)
    s = _where(keep, kappa // big, n)
    return g.replace(senders=s,
                     receivers=_where(keep, kappa - s * big, n),
                     weights=_where(keep, wsum, 0.0))


def _to_padding(g: Graph, dead: torch.Tensor) -> Graph:
    live = ~dead
    return g.replace(senders=_where(live, g.senders, g.num_nodes),
                     receivers=_where(live, g.receivers, g.num_nodes),
                     weights=_where(live, g.weights, 0.0))


def drop_zero_weight(g: Graph) -> Graph:
    """Turn zero-weight live edges into padding."""
    return _to_padding(g, (g.weights == 0) & g.edge_mask)


def to_undirected(g: Graph, reduce: str = "max") -> Graph:
    """Symmetrise: both directions of every live edge, coalesced. With
    reduce="max" an already symmetric graph is a fixed point. The capacity
    doubles."""
    big = g.replace(senders=torch.cat([g.senders, g.receivers]),
                    receivers=torch.cat([g.receivers, g.senders]),
                    weights=torch.cat([g.weights, g.weights]))
    return coalesce(big, reduce=reduce)


def remove_self_loops(g: Graph) -> Graph:
    return _to_padding(g, (g.senders == g.receivers) & g.edge_mask)


def add_self_loops(g: Graph, weight: float = 1.0) -> Graph:
    """Append one self-loop per (real) node. Grows capacity by num_nodes."""
    n = g.num_nodes
    loop_ids = torch.arange(n, dtype=g.senders.dtype, device=g.device)
    if g.node_mask is not None:
        loop_ids = torch.where(g.node_mask, loop_ids,
                               torch.full_like(loop_ids, n))
    lw = torch.where(loop_ids < n,
                     torch.full((n,), weight, dtype=g.weights.dtype,
                                device=g.device),
                     torch.zeros((n,), dtype=g.weights.dtype,
                                 device=g.device))
    return g.replace(senders=torch.cat([g.senders, loop_ids]),
                     receivers=torch.cat([g.receivers, loop_ids]),
                     weights=torch.cat([g.weights, lw]))


def _segment_sum_nodes(vals: torch.Tensor, idx: torch.Tensor,
                       n: int) -> torch.Tensor:
    out = torch.zeros((n + 1,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add(0, idx, vals)[:n]


def degrees(g: Graph) -> torch.Tensor:
    """Unweighted out-degree (= degree for symmetric graphs). float[n]."""
    return _segment_sum_nodes(g.edge_mask.to(g.weights.dtype), g.senders,
                              g.num_nodes)


def weighted_degrees(g: Graph) -> torch.Tensor:
    return _segment_sum_nodes(g.weights, g.senders, g.num_nodes)


def induced_subgraph(g: Graph, keep: torch.Tensor) -> Graph:
    """Kill edges with either endpoint outside `keep` (bool[num_nodes]).
    Node ids are preserved: nothing is relabelled."""
    kp = torch.cat([keep, torch.zeros((1,), dtype=torch.bool,
                                      device=keep.device)])
    alive = g.edge_mask & kp[g.senders] & kp[g.receivers]
    return _to_padding(g, ~alive)


def mirror_indices(g: Graph) -> torch.Tensor:
    """For a symmetric, coalesced, (s, r)-sorted edge list: the index of
    each edge's reversed twin. (Sorting by (r, s) lists the mirrors in
    order.)"""
    return torch.argsort(g.receivers * (g.num_nodes + 1) + g.senders,
                         stable=True)


def with_capacity(g: Graph, edge_capacity: int) -> Graph:
    """Grow (or shrink, when the tail is padding) the edge capacity."""
    cap = g.edge_capacity
    if edge_capacity == cap:
        return g
    if edge_capacity > cap:
        pad = edge_capacity - cap
        fill = torch.full((pad,), g.num_nodes, dtype=g.senders.dtype,
                          device=g.device)
        return g.replace(
            senders=torch.cat([g.senders, fill]),
            receivers=torch.cat([g.receivers, fill]),
            weights=torch.cat([g.weights, torch.zeros(
                (pad,), dtype=g.weights.dtype, device=g.device)]))
    g = sort_edges(g)
    return g.replace(senders=g.senders[:edge_capacity],
                     receivers=g.receivers[:edge_capacity],
                     weights=g.weights[:edge_capacity])


def block_diagonal(graphs: list, node_capacity: int, edge_capacity: int,
                   feature_dim: Optional[int] = None, device=None) -> tuple:
    """Disjoint union of `graphs` into one padded Graph, assembled on the
    host and built on `device` (the card by default).

    Returns (graph, segment_ids): segment_ids, int64[node_capacity], maps
    each node to the index of its source graph, padding nodes to
    len(graphs). Featureless graphs get x = ones of width `feature_dim`.
    """
    ss, rr, ww, xs, seg = [], [], [], [], []
    off = 0
    for gi, g in enumerate(graphs):
        m = g.edge_mask.cpu().numpy()
        ss.append(g.senders.cpu().numpy()[m] + off)
        rr.append(g.receivers.cpu().numpy()[m] + off)
        ww.append(g.weights.cpu().numpy()[m])
        if g.x is not None:
            xs.append(g.x.cpu().numpy())
        seg.append(np.full((g.num_nodes,), gi, np.int64))
        off += g.num_nodes
    if off > node_capacity:
        raise ValueError(f"node_capacity {node_capacity} < total nodes {off}")
    s = np.concatenate(ss) if ss else np.zeros((0,), np.int64)
    r = np.concatenate(rr) if rr else np.zeros((0,), np.int64)
    w = np.concatenate(ww) if ww else np.zeros((0,), np.float64)
    if s.shape[0] > edge_capacity:
        raise ValueError(
            f"edge_capacity {edge_capacity} < total edges {s.shape[0]}")
    seg_ids = np.full((node_capacity,), len(graphs), np.int64)
    if seg:
        seg_ids[:off] = np.concatenate(seg)
    node_mask = np.zeros((node_capacity,), bool)
    node_mask[:off] = True
    x = None
    if xs:
        x = np.zeros((node_capacity, xs[0].shape[1]), xs[0].dtype)
        x[:off] = np.concatenate(xs, axis=0)
    elif feature_dim is not None:
        x = np.zeros((node_capacity, feature_dim), np.float32)
        x[:off] = 1.0
    dev = resolve_device(device)
    g = Graph.from_edges(s, r, num_nodes=node_capacity, weights=w,
                         edge_capacity=edge_capacity, device=dev)
    g = g.replace(x=None if x is None else torch.as_tensor(x, device=dev),
                  node_mask=torch.as_tensor(node_mask, device=dev))
    return g, torch.as_tensor(seg_ids, device=dev)


def to_dense(g: Graph) -> torch.Tensor:
    n = g.num_nodes
    a = torch.zeros((n + 1, n + 1), dtype=g.weights.dtype, device=g.device)
    a.index_put_((g.senders, g.receivers), g.weights, accumulate=True)
    return a[:n, :n]


def laplacian_dense(g: Graph) -> torch.Tensor:
    """L = D - A."""
    a = to_dense(g)
    return torch.diag(a.sum(1)) - a
