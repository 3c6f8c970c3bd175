"""Sparse message passing over padded COO edge lists: SpMM, SDDMM and the
GCN normalisation. Counterpart of `rlap_tpu/ops/spmm.py`.

Plain PyTorch on the card for now: gather, scale and `index_add_` into
n+1 rows, then drop the sentinel row. On CUDA `index_add_` uses atomics,
so float sums are taken in no fixed order. With a `mesh`, the graph is
this rank's shard (`rlap_tpu_torch.parallel`): its slice of the edges,
with the global `num_nodes`.
"""

from __future__ import annotations

from typing import Optional

import torch

from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.utils import tracing


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1, x.shape[1]))], 0)


def spmm(g: Graph, x: torch.Tensor,
         edge_weights: Optional[torch.Tensor] = None, mesh=None,
         axis: str = "data") -> torch.Tensor:
    """out[i] = sum over edges (j -> i) of w_e * x[j].  x: [N, F] -> [N, F].

    Padding edges (sender == num_nodes) read and write the dropped sentinel
    row. With `mesh`, `g` is this rank's shard and the sum runs over the
    edges of every rank of `axis` (`parallel.spmm_edge_partitioned`: one
    all-reduce of the ranks' partials); `x` and the result are
    replicated.

    While a profiler records (`utils/tracing.py`), the single-rank path
    counts the gathered slots (`spmm.slots`) and the padding slots among
    them, which all read the sentinel row (`spmm.padding`)."""
    if mesh is not None:
        from rlap_tpu_torch.parallel.spmm import spmm_edge_partitioned

        return spmm_edge_partitioned(g, x, mesh, axis=axis,
                                     edge_weights=edge_weights)
    if tracing.recording():
        tracing.count("spmm.slots", g.senders.shape[0])
        tracing.count("spmm.padding", (g.senders == g.num_nodes).sum())
    w = g.weights if edge_weights is None else edge_weights
    msgs = _pad_row(x)[g.senders] * w[:, None].to(x.dtype)
    out = x.new_zeros((g.num_nodes + 1, x.shape[1]))
    return out.index_add(0, g.receivers, msgs)[:g.num_nodes]


def sddmm(g: Graph, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-edge dot products: out_e = <a[sender_e], b[receiver_e]>."""
    return (_pad_row(a)[g.senders] * _pad_row(b)[g.receivers]).sum(-1)


def gcn_norm(g: Graph, add_self_loops: bool = True, mesh=None,
             axis: str = "data") -> tuple:
    """Symmetric GCN normalisation w_e / sqrt(d_s d_r), the degree summed
    over senders. With `add_self_loops`, self-loops of weight 1 replace
    any present and count in the degree; without, the graph is taken as
    it is (CCA-SSG adds its loops to the views itself). (The JAX
    package's `improved` option has no caller.)

    With `mesh`, `g` is this rank's shard: each rank adds the loops of its
    own node block, and the degrees are the global ones, the ranks'
    partials all-reduced over `axis`.

    Returns (graph_with_loops, normalized_edge_weights).
    """
    if add_self_loops:
        g = G.remove_self_loops(g)
        if mesh is None:
            g = G.add_self_loops(g)
        else:
            from rlap_tpu_torch.parallel.mesh import node_block

            cap = g.edge_capacity
            lo, hi = node_block(g.num_nodes, mesh, axis)
            g = G.add_self_loops(g)
            keep = torch.cat([torch.arange(cap, device=g.device),
                              torch.arange(cap + lo, cap + hi,
                                           device=g.device)])
            g = g.replace(senders=g.senders[keep],
                          receivers=g.receivers[keep],
                          weights=g.weights[keep])
    deg = G.weighted_degrees(g)
    if mesh is not None:
        import torch.distributed as dist

        dist.all_reduce(deg, group=mesh.get_group(axis))
    dinv = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)),
                       torch.zeros_like(deg))
    dpad = torch.cat([dinv, dinv.new_zeros((1,))])
    return g, g.weights * dpad[g.senders] * dpad[g.receivers]
