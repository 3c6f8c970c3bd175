"""Sparse message passing over padded COO edge lists: SpMM, SDDMM and the
GCN normalisation. Counterpart of `rlap_tpu/ops/spmm.py` (the `mesh`
branch waits for the sharded layer).

Plain PyTorch on the card for now: gather, scale and `index_add_` into
n+1 rows, then drop the sentinel row. On CUDA `index_add_` uses atomics,
so float sums are taken in no fixed order.
"""

from __future__ import annotations

from typing import Optional

import torch

from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core.graph import Graph


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1, x.shape[1]))], 0)


def spmm(g: Graph, x: torch.Tensor,
         edge_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[i] = sum over edges (j -> i) of w_e * x[j].  x: [N, F] -> [N, F].

    Padding edges (sender == num_nodes) read and write the dropped sentinel
    row."""
    w = g.weights if edge_weights is None else edge_weights
    msgs = _pad_row(x)[g.senders] * w[:, None].to(x.dtype)
    out = x.new_zeros((g.num_nodes + 1, x.shape[1]))
    return out.index_add(0, g.receivers, msgs)[:g.num_nodes]


def sddmm(g: Graph, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-edge dot products: out_e = <a[sender_e], b[receiver_e]>."""
    return (_pad_row(a)[g.senders] * _pad_row(b)[g.receivers]).sum(-1)


def gcn_norm(g: Graph, add_self_loops: bool = True) -> tuple:
    """Symmetric GCN normalisation w_e / sqrt(d_s d_r), the degree summed
    over senders. With `add_self_loops`, self-loops of weight 1 replace
    any present and count in the degree; without, the graph is taken as
    it is (CCA-SSG adds its loops to the views itself). (The JAX
    package's `improved` option has no caller.)

    Returns (graph_with_loops, normalized_edge_weights).
    """
    if add_self_loops:
        g = G.add_self_loops(G.remove_self_loops(g))
    deg = G.weighted_degrees(g)
    dinv = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)),
                       torch.zeros_like(deg))
    dpad = torch.cat([dinv, dinv.new_zeros((1,))])
    return g, g.weights * dpad[g.senders] * dpad[g.receivers]
