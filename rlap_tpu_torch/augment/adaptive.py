"""GCA-style adaptive edge dropping by degree, PageRank or eigenvector
centrality (counterpart of `rlap_tpu/augment/adaptive.py`).

Both centralities are power iterations of the port's `spmm` over the
padded edge list. The scores are taken on the coalesced graph, so that
they line up with its edge slots, and the drop takes one coin per
undirected pair.
"""

from __future__ import annotations

import torch

from rlap_tpu_torch.augment.base import Augmentor
from rlap_tpu_torch.augment.edge import _keep_canonical
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.ops.spmm import spmm


def _pad_one(v: torch.Tensor) -> torch.Tensor:
    """v with a 1 appended, so that the sentinel index reads log(1) = 0."""
    return torch.cat([v, v.new_ones((1,))])


def compute_pagerank(g: Graph, damp: float = 0.85,
                     k: int = 10) -> torch.Tensor:
    """k steps of x <- (1 - damp) x + damp A^T (x / deg_out), x0 = ones,
    on the unweighted graph."""
    deg_out = G.degrees(g)
    x = torch.ones(g.num_nodes, dtype=g.weights.dtype, device=g.device)
    inv_deg = torch.where(deg_out > 0, 1.0 / deg_out.clamp_min(1.0),
                          torch.zeros_like(deg_out))
    w1 = g.edge_mask.to(x.dtype)
    for _ in range(k):
        agg = spmm(g, (x * inv_deg)[:, None], edge_weights=w1)[:, 0]
        x = (1 - damp) * x + damp * agg
    return x


def eigenvector_centrality(g: Graph, iters: int = 100) -> torch.Tensor:
    """Power method on the unweighted adjacency plus the identity, the
    vector normalised to unit length over the graph's nodes every step."""
    x = torch.ones(g.num_nodes, dtype=g.weights.dtype, device=g.device)
    w1 = g.edge_mask.to(x.dtype)
    for _ in range(iters):
        y = spmm(g, x[:, None], edge_weights=w1)[:, 0] + x
        x = y / torch.linalg.vector_norm(y).clamp_min(1e-12)
    return x


def _normalize_drop_scores(s: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """w = (s_max - s) / (s_max - s_mean) over the live edges."""
    smax = torch.where(mask, s, torch.full_like(s, -torch.inf)).max()
    cnt = mask.to(s.dtype).sum().clamp_min(1.0)
    smean = torch.where(mask, s, torch.zeros_like(s)).sum() / cnt
    return (smax - s) / (smax - smean).clamp_min(1e-12)


def degree_drop_weights(g: Graph) -> torch.Tensor:
    """s = log deg(receiver)."""
    s = torch.log(_pad_one(G.degrees(g))[g.receivers].clamp_min(1e-12))
    return _normalize_drop_scores(s, g.edge_mask)


def pr_drop_weights(g: Graph, aggr: str = "sink", k: int = 10
                    ) -> torch.Tensor:
    """s = log PageRank of the receiver ("sink", and any other value),
    the sender ("source"), or their mean ("mean")."""
    pvp = _pad_one(compute_pagerank(g, k=k))
    s_row = torch.log(pvp[g.senders].clamp_min(1e-12))
    s_col = torch.log(pvp[g.receivers].clamp_min(1e-12))
    s = {"source": s_row, "mean": 0.5 * (s_row + s_col)}.get(aggr, s_col)
    return _normalize_drop_scores(s, g.edge_mask)


def evc_drop_weights(g: Graph) -> torch.Tensor:
    """s = log(EVC(receiver) + 1e-8)."""
    evc = eigenvector_centrality(g).clamp_min(0.0) + 1e-8
    s = torch.log(_pad_one(evc)[g.receivers])
    return _normalize_drop_scores(s, g.edge_mask)


def _drop_probability(g: Graph, drop_w: torch.Tensor, p: float,
                      threshold: float) -> torch.Tensor:
    """min(p * w / mean(w over live edges), threshold)."""
    mask = g.edge_mask
    cnt = mask.to(drop_w.dtype).sum().clamp_min(1.0)
    mean_w = torch.where(mask, drop_w, torch.zeros_like(drop_w)).sum() / cnt
    return (drop_w / mean_w.clamp_min(1e-12) * p).clamp_max(threshold)


def drop_edge_weighted(g: Graph, drop_w: torch.Tensor,
                       key: torch.Generator, p: float,
                       threshold: float = 1.0) -> Graph:
    """Drop each undirected pair with probability min(p w / mean(w),
    threshold). `g` must be coalesced and sorted, so that `drop_w` lines
    up with its edge slots."""
    u = torch.rand(g.edge_capacity, generator=key, device=g.device)
    return _keep_canonical(g, u, _drop_probability(g, drop_w, p, threshold))


class _AdaptiveEdgeDropping(Augmentor):
    def __init__(self, p: float, threshold: float = 0.7):
        self.p = p
        self.threshold = threshold

    def _scores(self, g: Graph) -> torch.Tensor:
        raise NotImplementedError

    def augment(self, g: Graph, key: torch.Generator) -> Graph:
        gs = G.coalesce(g)
        return drop_edge_weighted(gs, self._scores(gs), key, self.p,
                                  self.threshold)


class EdgeDroppingDegree(_AdaptiveEdgeDropping):
    def _scores(self, g):
        return degree_drop_weights(g)


class EdgeDroppingPR(_AdaptiveEdgeDropping):
    def _scores(self, g):
        return pr_drop_weights(g)


class EdgeDroppingEVC(_AdaptiveEdgeDropping):
    def _scores(self, g):
        return evc_drop_weights(g)
