"""GIN convolution and encoder (counterpart of `rlap_tpu/nn/gin.py`).

GINConv is MLP((1 + eps) x + sum of the neighbours' x), eps fixed at 0;
the encoder is num_layers x (GINConv -> ReLU -> masked BatchNorm) and
reads out the concatenation of every layer's nodes and of their sum-pools
per graph.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.nn.layers import MLP, MaskedBatchNorm, global_add_pool
from rlap_tpu_torch.ops.spmm import spmm


class GINConv(nn.Module):
    """`mesh`: the graph is this rank's shard (`rlap_tpu_torch.parallel`)
    and the neighbour sum runs over the ranks of the mesh's "data" axis;
    features and output are replicated."""

    def __init__(self, in_dim: int, hidden_dim: int, eps: float = 0.0,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        self.eps = eps
        self.mesh = mesh
        self.mlp = MLP(in_dim, [hidden_dim, hidden_dim], generator=generator)

    def forward(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        return self.mlp((1.0 + self.eps) * x + spmm(g, x, mesh=self.mesh))


class GINEncoder(nn.Module):
    """Returns (node embedding, graph embedding), each the concatenation
    over layers; padding nodes are zeroed in the node embedding. `mesh` as
    `GINConv`'s; the batch norms see replicated features."""

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 2,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * num_layers
        self.convs = nn.ModuleList(
            GINConv(dims[i], hidden_dim, generator=generator, mesh=mesh)
            for i in range(num_layers))
        self.bns = nn.ModuleList(MaskedBatchNorm(hidden_dim)
                                 for _ in range(num_layers))

    def forward(self, g: Graph, x: torch.Tensor, segment_ids: torch.Tensor,
                num_graphs: int, train: bool = True):
        zs = []
        for conv, bn in zip(self.convs, self.bns):
            x = bn(torch.relu(conv(g, x)), mask=g.node_mask,
                   use_running_average=not train)
            zs.append(x)
        z = torch.cat(zs, -1)
        if g.node_mask is not None:
            z = z * g.node_mask.to(z.dtype)[:, None]
        gemb = torch.cat([global_add_pool(zz, segment_ids, num_graphs)
                          for zz in zs], -1)
        return z, gemb
