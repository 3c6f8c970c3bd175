"""GCN convolution, encoder and projection head (counterpart of
`rlap_tpu/nn/gcn.py`).

Initialisers follow flax, not torch: the GCN weight is glorot-uniform, the
projection head's dense layers lecun-normal (a normal truncated at two
standard deviations, rescaled to variance 1/fan_in), biases zero. Weights
are drawn from an explicit generator so a model is a function of its seed.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.nn.layers import PReLU, _dense
from rlap_tpu_torch.ops.spmm import gcn_norm, spmm

class GCNConv(nn.Module):
    """x @ W (glorot-uniform, no bias), symmetric normalisation (with
    self-loops unless `add_self_loops` is False), SpMM aggregation, then a
    zero-initialised bias.

    `mesh`: the graph is this rank's shard (`rlap_tpu_torch.parallel`),
    normalised by the global degrees and aggregated over the ranks of the
    mesh's "data" axis; features and output are replicated."""

    def __init__(self, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None,
                 add_self_loops: bool = True, mesh=None):
        super().__init__()
        self.lin = nn.Linear(in_dim, out_dim, bias=False)
        nn.init.xavier_uniform_(self.lin.weight, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self.add_self_loops = add_self_loops
        self.mesh = mesh

    def forward(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        gl, wn = gcn_norm(g, add_self_loops=self.add_self_loops,
                          mesh=self.mesh)
        return spmm(gl, self.lin(x), edge_weights=wn,
                    mesh=self.mesh) + self.bias


class GCNEncoder(nn.Module):
    """num_layers x (GCNConv -> PReLU), one slope per layer; `mesh` as
    `GCNConv`'s."""

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 2,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * num_layers
        self.convs = nn.ModuleList(
            GCNConv(dims[i], dims[i + 1], generator=generator, mesh=mesh)
            for i in range(num_layers))
        self.acts = nn.ModuleList(PReLU() for _ in range(num_layers))

    def forward(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        for conv, act in zip(self.convs, self.acts):
            x = act(conv(g, x))
        return x


class ProjectionHead(nn.Module):
    """fc1 -> ELU -> fc2."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = _dense(in_dim, hidden_dim, generator)
        self.fc2 = _dense(hidden_dim, out_dim, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.fc2(nn.functional.elu(self.fc1(z)))
