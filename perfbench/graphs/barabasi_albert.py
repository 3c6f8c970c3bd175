"""A Barabasi-Albert graph with Gaussian node features, made on the
device from the seed in a few large calls.

It draws preferential attachment by the same law as
`rlap_tpu_torch.data.synthetic.barabasi_albert` (node v links to m
endpoints drawn uniformly, with replacement, from the list of the
endpoints of every earlier edge; repeated draws make one edge), but all
edges at once: each draw names a slot of that list, and a slot that holds
an earlier draw's target is resolved by pointer jumping (the
Batagelj-Brandes form). The host loop of the program's generator takes
seconds at this size; this takes milliseconds. It is frozen here so that a
change to the program cannot change the inputs.
"""

from __future__ import annotations

import torch

from perfbench import seeds


def ba_edges(n: int, m: int, gen: torch.Generator, device):
    """Sorted symmetric directed edges (senders, receivers), int64, of a
    BA(n, m) graph: node m links to 0..m-1, and node v > m to m draws
    from the endpoint list of nodes m..v-1's edges."""
    if not 0 < m < n:
        raise ValueError(f"BA needs 0 < m < n, got m={m}, n={n}")
    e = m * (n - m)
    k = torch.arange(e, device=device)
    u = k // m + m                       # the node that draws
    j = k % m
    span = 2 * m * (u - m)               # endpoint slots before u's edges
    r = (torch.rand(e, generator=gen, device=device, dtype=torch.float64)
         * span).long().clamp_max(torch.clamp(span - 1, min=0))
    batch, off = r // (2 * m), r % (2 * m)
    # a slot holds either the node that drew (second half of its batch)
    # or one of that node's targets (first half): a pointer to its draw
    val = torch.where(off >= m, batch + m, torch.full_like(r, -1))
    val = torch.where(u == m, j, val)
    ptr = torch.where(val < 0, batch * m + off, k)
    while True:
        todo = val < 0
        if not bool(todo.any()):
            break
        pv = val[ptr]
        val = torch.where(todo & (pv >= 0), pv, val)
        ptr = torch.where(todo & (pv < 0), ptr[ptr], ptr)
    keys = torch.unique(torch.cat([u * n + val, val * n + u]))
    return keys // n, keys % n


def make(spec: dict, seed: int, device):
    """BA(`num_nodes`, `m`) with `num_features` features a node, as the
    program's `Graph`: symmetric, unit weights, padded to a multiple of
    128 edges as `Graph.from_edges` pads."""
    from rlap_tpu_torch.core.graph import Graph

    n, m, f = spec["num_nodes"], spec["m"], spec["num_features"]
    s, r = ba_edges(n, m, seeds.generator(seed, "graph", device), device)
    cap = max(-(-s.shape[0] // 128) * 128, 128)
    pad = cap - s.shape[0]
    fill = torch.full((pad,), n, dtype=torch.int64, device=device)
    w = torch.cat([torch.ones(s.shape[0], device=device),
                   torch.zeros(pad, device=device)])
    x = torch.randn(n, f, generator=seeds.generator(seed, "features", device),
                    device=device, dtype=torch.float32)
    return Graph(senders=torch.cat([s, fill]), receivers=torch.cat([r, fill]),
                 weights=w, num_nodes=n, x=x)
