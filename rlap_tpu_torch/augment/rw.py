"""Random-walk subgraph sampling (counterpart of `rlap_tpu/augment/rw.py`).

Walkers advance one step at a time; each step draws a uniform live
neighbour from the coalesced, sender-sorted edge list (edge slot =
start[v] + floor(u * deg[v])). A walker on a node without edges stays.
"""

from __future__ import annotations

import torch

from rlap_tpu_torch.augment.base import Augmentor
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.core.rng import split


def _walk(gs: Graph, cur: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """bool[n]: the nodes visited by walkers starting at `cur` on the
    coalesced graph `gs`, step i drawing with the uniforms us[i]."""
    n, cap = gs.num_nodes, gs.edge_capacity
    deg = G.degrees(gs).to(torch.int64)
    start = torch.cat([deg.new_zeros((1,)), torch.cumsum(deg, 0)])
    recv = torch.cat([gs.receivers, gs.receivers.new_full((1,), n)])
    visited = torch.zeros(n, dtype=torch.bool, device=gs.device)
    visited[cur] = True
    for u in us:
        d = deg[cur]
        off = torch.floor(u * d.clamp_min(1).to(u.dtype)).to(torch.int64)
        slot = torch.where(d > 0, start[cur] + torch.minimum(off, d - 1),
                           cap)
        nxt = recv[slot.clamp_max(cap)]
        cur = torch.where(nxt < n, nxt, cur)
        visited[cur] = True
    return visited


def random_walk_nodes(g: Graph, key: torch.Generator, num_seeds: int,
                      walk_length: int) -> torch.Tensor:
    """bool[num_nodes]: nodes visited by `num_seeds` walks of
    `walk_length` steps from uniformly drawn start nodes."""
    k_seed, k_step = split(key)
    cur = torch.randint(0, g.num_nodes, (num_seeds,), generator=k_seed,
                        device=g.device)
    us = torch.rand(walk_length, num_seeds, generator=k_step,
                    device=g.device)
    return _walk(G.coalesce(g), cur, us)


class RWSampling(Augmentor):
    """The subgraph induced by the nodes that random walks visit."""

    def __init__(self, num_seeds: int, walk_length: int = 10):
        self.num_seeds = num_seeds
        self.walk_length = walk_length

    def augment(self, g: Graph, key: torch.Generator) -> Graph:
        visited = random_walk_nodes(g, key, self.num_seeds, self.walk_length)
        if g.node_mask is not None:
            visited = visited & g.node_mask
        return G.induced_subgraph(g, visited)
