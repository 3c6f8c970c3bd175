"""Edge partitioning by sender block (counterpart of
`rlap_tpu/parallel/partition.py`).

Node ids are cut into contiguous equal blocks, one a shard, and every
edge (i, j) goes to the shard that owns node i. A node's whole column
then lives on its owner, so the sharded elimination gathers a column
without a collective, and the shards' SpMM partials touch disjoint rows.
Host-side numpy: placement happens once a graph, and needs no process
group.
"""

from __future__ import annotations

import numpy as np
import torch

from rlap_tpu_torch.core.graph import Graph


def node_block_owner(node_ids, num_nodes: int, num_shards: int):
    """Owner shard of each node id under contiguous equal blocks (numpy
    arrays or tensors)."""
    block = -(-num_nodes // num_shards)
    return (node_ids // block).clip(max=num_shards - 1)


def partition_edges_by_sender(g: Graph, num_shards: int) -> Graph:
    """Reorder and pad the edges so that shard s's slice
    [s cap : (s + 1) cap] holds exactly the edges whose sender is in node
    block s, padding after them. cap is the largest block's edge count
    rounded up to 128; the capacity becomes num_shards * cap."""
    s = g.senders.cpu().numpy()
    r = g.receivers.cpu().numpy()
    w = g.weights.cpu().numpy()
    n = g.num_nodes
    live = s < n
    s, r, w = s[live], r[live], w[live]
    owner = node_block_owner(s, n, num_shards)
    counts = np.bincount(owner, minlength=num_shards)
    cap = int(((counts.max() + 127) // 128) * 128) if counts.size else 128
    ss = np.full((num_shards, cap), n, np.int64)
    rr = np.full((num_shards, cap), n, np.int64)
    ww = np.zeros((num_shards, cap), w.dtype)
    for shard in range(num_shards):
        sel = owner == shard
        k = int(sel.sum())
        ss[shard, :k] = s[sel]
        rr[shard, :k] = r[sel]
        ww[shard, :k] = w[sel]
    dev = g.device
    return g.replace(senders=torch.as_tensor(ss.reshape(-1), device=dev),
                     receivers=torch.as_tensor(rr.reshape(-1), device=dev),
                     weights=torch.as_tensor(ww.reshape(-1), device=dev))
