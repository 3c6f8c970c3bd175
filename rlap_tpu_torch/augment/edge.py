"""Topology augmentors: edge addition, edge removal, node dropping
(counterpart of `rlap_tpu/augment/edge.py`).

Each augmentor draws its random numbers and hands them to a private
function of the graph and the draw, so that a test can feed in the JAX
package's draws and compare the graphs exactly. Removal takes one coin
per undirected pair (both directions read the canonical slot's uniform),
so symmetric graphs stay symmetric.
"""

from __future__ import annotations

import torch

from rlap_tpu_torch.augment.base import Augmentor
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.core.rng import split


def _add_pairs(g: Graph, u: torch.Tensor, v: torch.Tensor,
               pe: float) -> Graph:
    """Append both directions of the first `num_add / 2` pairs (u_i, v_i)
    that are not loops (and join real nodes), weight 1, then merge with
    the graph by max. `num_add = int(pe * live edges)`, truncated in
    float32 as in the JAX package."""
    n = g.num_nodes
    num_add = (torch.tensor(pe, dtype=torch.float32, device=g.device)
               * g.num_edges.to(torch.float32)).to(torch.int64)
    idx = torch.arange(u.shape[0], device=g.device)
    live = (idx * 2 < num_add) & (u != v)
    if g.node_mask is not None:
        live = live & g.node_mask[u] & g.node_mask[v]
    s_new = torch.where(live, u, n)
    r_new = torch.where(live, v, n)
    w_new = live.to(g.weights.dtype)
    big = g.replace(senders=torch.cat([g.senders, s_new, r_new]),
                    receivers=torch.cat([g.receivers, r_new, s_new]),
                    weights=torch.cat([g.weights, w_new, w_new]))
    return G.coalesce(G.drop_zero_weight(big), reduce="max")


def _keep_canonical(gs: Graph, u: torch.Tensor, prob) -> Graph:
    """Keep edge e of the coalesced, sorted `gs` where u[canon(e)] >= its
    drop probability, canon(e) being the smaller of e and its mirror's
    slot: one coin per undirected pair."""
    idx = torch.arange(gs.edge_capacity, device=gs.device)
    canon = torch.minimum(idx, G.mirror_indices(gs))
    keep = (u[canon] >= prob) & gs.edge_mask
    return G._to_padding(gs, ~keep)


class EdgeAdding(Augmentor):
    """Insert int(pe * E) uniformly random edges (both directions of
    random pairs), then coalesce. The capacity grows by
    2 * ceil((int(pe * capacity) + 1) / 2)."""

    def __init__(self, pe: float):
        self.pe = pe

    def augment(self, g: Graph, key: torch.Generator) -> Graph:
        add_cap = max(int(self.pe * g.edge_capacity) + 1, 1)
        half = (add_cap + 1) // 2
        k1, k2 = split(key)
        u = torch.randint(0, g.num_nodes, (half,), generator=k1,
                          device=g.device)
        v = torch.randint(0, g.num_nodes, (half,), generator=k2,
                          device=g.device)
        return _add_pairs(g, u, v, self.pe)


class EdgeRemoving(Augmentor):
    """Drop each undirected pair with probability pe. The output is the
    coalesced graph with dropped edges turned into padding."""

    def __init__(self, pe: float):
        self.pe = pe

    def augment(self, g: Graph, key: torch.Generator) -> Graph:
        gs = G.coalesce(g)
        u = torch.rand(gs.edge_capacity, generator=key, device=g.device)
        return _keep_canonical(gs, u, self.pe)


def _drop_nodes(g: Graph, u: torch.Tensor, pn: float) -> Graph:
    keep = u >= pn
    if g.node_mask is not None:
        keep = keep & g.node_mask
    return G.induced_subgraph(g, keep)


class NodeDropping(Augmentor):
    """Remove every edge of a Bernoulli(pn) subset of the nodes (ids are
    kept)."""

    def __init__(self, pn: float):
        self.pn = pn

    def augment(self, g: Graph, key: torch.Generator) -> Graph:
        u = torch.rand(g.num_nodes, generator=key, device=g.device)
        return _drop_nodes(g, u, self.pn)
