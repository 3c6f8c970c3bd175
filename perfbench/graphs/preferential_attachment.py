"""A preferential-attachment graph with an exact edge count, and Gaussian
node features, drawn from the seed.

Barabasi-Albert with a whole m cannot reach a published edge count such
as PubMed's 44,324 undirected edges over 19,717 nodes (2.25 a node). Here
nodes 0..m form a clique, and each later node v links to m or m + 1
distinct earlier nodes, drawn with probability proportional to their
degree (uniformly from the endpoints of every earlier edge, a repeated
draw drawn again); the nodes that take m + 1 are a uniform sample of the
exact size that makes `num_edges` edges. The draws come from Python's
`random.Random` on the host (about 45,000 of them, a few tens of ms), so
the edges are the same on every device; the features, as BA's, are drawn
on the device.
"""

from __future__ import annotations

import random

import torch

from perfbench import seeds


def pa_edges(n: int, num_edges: int, m: int, rng: random.Random):
    """The undirected edges (u, v), u > v, as two lists."""
    base = m * (m + 1) // 2
    extra = num_edges - base - m * (n - m - 1)
    if not 0 < m < n - 1 or not 0 <= extra <= n - m - 1:
        raise ValueError(f"{num_edges} edges over {n} nodes are out of reach "
                         f"of {m} or {m + 1} links a node")
    us = [u for u in range(1, m + 1) for _ in range(u)]
    vs = [v for u in range(1, m + 1) for v in range(u)]
    ends = us + vs
    more = set(rng.sample(range(m + 1, n), extra))
    for u in range(m + 1, n):
        want = m + 1 if u in more else m
        picked = set()
        while len(picked) < want:
            picked.add(ends[rng.randrange(len(ends))])
        for v in sorted(picked):
            us.append(u)
            vs.append(v)
            ends += (u, v)
    return us, vs


def make(spec: dict, seed: int, device):
    """`num_nodes` nodes, exactly `num_edges` undirected edges (both
    directions stored, sorted), `num_features` features a node, as the
    program's `Graph`: unit weights, padded to a multiple of 128 edges as
    `Graph.from_edges` pads."""
    from rlap_tpu_torch.core.graph import Graph

    n, f = spec["num_nodes"], spec["num_features"]
    us, vs = pa_edges(n, spec["num_edges"], spec["m"],
                      random.Random(seeds.derive(seed, "graph")))
    u = torch.tensor(us, dtype=torch.int64, device=device)
    v = torch.tensor(vs, dtype=torch.int64, device=device)
    keys = torch.sort(torch.cat([u * n + v, v * n + u])).values
    s, r = keys // n, keys % n
    cap = max(-(-s.shape[0] // 128) * 128, 128)
    pad = cap - s.shape[0]
    fill = torch.full((pad,), n, dtype=torch.int64, device=device)
    w = torch.cat([torch.ones(s.shape[0], device=device),
                   torch.zeros(pad, device=device)])
    x = torch.randn(n, f, generator=seeds.generator(seed, "features", device),
                    device=device, dtype=torch.float32)
    return Graph(senders=torch.cat([s, fill]), receivers=torch.cat([r, fill]),
                 weights=w, num_nodes=n, x=x)
