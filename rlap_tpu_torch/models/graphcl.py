"""GraphCL: graph-to-graph (G2G) contrast on datasets of small graphs
(counterpart of `rlap_tpu/models/graphcl.py`).

A GIN encoder with a concatenated sum-pool readout and a projection MLP;
each batch is one block-diagonal union of graphs, augmented as a whole;
InfoNCE between the two views' projected graph embeddings at tau = 0.2.
Evaluation embeds the clean graphs with the running batch statistics.
Graphs without features get x = ones of width 1.

With a `mesh` (`rlap_tpu_torch.parallel`), every rank of the mesh runs
the trainer: each batch's edges are sharded over the mesh's "data" axis
and the GIN aggregation sums over the shards; the parameters, the batch
statistics and the loss are replicated.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.models.common import (checkpointed_fit, init_generator,
                                          make_union_batches, torch_adam)
from rlap_tpu_torch.nn.gin import GINEncoder
from rlap_tpu_torch.nn.layers import MLP
from rlap_tpu_torch.objectives.contrast import DualBranchContrast

FEATURELESS_DIM = 1


class GraphCL(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int = 32,
                 num_layers: int = 2,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        self.encoder = GINEncoder(in_dim, hidden_dim, num_layers,
                                  generator=generator, mesh=mesh)
        d = hidden_dim * num_layers
        self.project = MLP(d, [d, d], generator=generator)

    def forward(self, g: Graph, seg: torch.Tensor, num_graphs: int,
                train: bool = True):
        z, gemb = self.encoder(g, g.x, seg, num_graphs, train=train)
        return z, gemb, self.project(gemb)


def buffers_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of the module's buffers (its batch statistics)."""
    return {k: v.detach().clone() for k, v in model.named_buffers()}


def copy_into(dst: Dict[str, torch.Tensor],
              values: Dict[str, torch.Tensor]) -> None:
    """Copy `values` into the tensors of `dst`, which must have the same
    names."""
    if set(dst) != set(values):
        raise KeyError(f"names {sorted(values)} do not match "
                       f"{sorted(dst)}")
    with torch.no_grad():
        for k, v in values.items():
            dst[k].copy_(v)


class GraphCLTrainer:
    """GraphCL training on `device` (the card by default).

    `mesh`: a `DeviceMesh` with a "data" axis, every rank of it running
    this trainer with the same arguments and graphs. Each batch's two
    views are made on the mesh's first rank and sent to the others, and
    each rank trains on its slice of their edges (`GraceTrainer`'s
    `mesh` says why); the gradients are averaged over the mesh. The clean
    batches of `embed_graphs` are sliced the same way.
    """

    _ckpt_extra = ("batch_stats",)

    def __init__(self, aug1, aug2, hidden_dim: int = 32,
                 num_layers: int = 2, lr: float = 1e-2,
                 weight_decay: float = 0.0, tau: float = 0.2,
                 batch_size: int = 128, seed: int = 0, mesh=None,
                 device=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.aug1, self.aug2 = aug1, aug2
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        self.lr, self.weight_decay = lr, weight_decay
        self.contrast = DualBranchContrast(loss="infonce", mode="G2G",
                                           tau=tau)
        self.batch_size = batch_size
        self.key = rng.key(seed, device=self.device)
        self.model: Optional[GraphCL] = None
        self.optimizer: Optional[torch.optim.Adam] = None

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return buffers_of(self.model)

    @batch_stats.setter
    def batch_stats(self, stats: Dict[str, torch.Tensor]) -> None:
        copy_into(dict(self.model.named_buffers()), stats)

    def make_batches(self, graphs: Sequence[Graph], shuffle_seed: int = 0):
        return make_union_batches(graphs, self.batch_size,
                                  shuffle_seed=shuffle_seed,
                                  device=self.device,
                                  feature_dim=FEATURELESS_DIM)

    def ensure_init(self, graphs: Sequence[Graph]) -> None:
        if self.model is not None:
            return
        x = graphs[0].x
        in_dim = FEATURELESS_DIM if x is None else x.shape[1]
        self.model = GraphCL(in_dim, self.hidden_dim, self.num_layers,
                             generator=init_generator(self),
                             mesh=self.mesh).to(self.device)
        self.optimizer = torch_adam(self.model.parameters(), self.lr,
                                    self.weight_decay)

    def train_step(self, g1: Graph, g2: Graph, seg: torch.Tensor,
                   num_graphs: int) -> float:
        """One Adam step on a batch's two views (with a mesh, this rank's
        shards of them); the batch statistics are updated by the first
        view's pass, then by the second's."""
        self.optimizer.zero_grad(set_to_none=True)
        _, _, h1 = self.model(g1, seg, num_graphs, train=True)
        _, _, h2 = self.model(g2, seg, num_graphs, train=True)
        loss = self.contrast(g1=h1, g2=h2)
        loss.backward()
        if self.mesh is not None:
            from rlap_tpu_torch.parallel.mesh import average_gradients

            average_gradients(self.model.parameters(), self.mesh)
        self.optimizer.step()
        return float(loss.detach())

    def train_epoch(self, graphs: Sequence[Graph], epoch: int = 0) -> float:
        """One pass over batches shuffled by `epoch`; the sum of the
        batches' losses."""
        self.ensure_init(graphs)
        total = 0.0
        for batch, seg, ng in self.make_batches(graphs, shuffle_seed=epoch):
            self.key, k1, k2 = rng.split(self.key, 3)
            make = lambda: (self.aug1(batch, k1),
                            self.aug2(batch, k2))
            if self.mesh is None:
                g1, g2 = make()
            else:
                from rlap_tpu_torch.parallel.mesh import shard_views

                g1, g2 = shard_views(make, self.mesh, self.device)
            total += self.train_step(g1, g2, seg, ng)
        return total

    def fit(self, graphs: Sequence[Graph], max_epochs: int = 100,
            tolerance: int = 20, verbose: bool = False,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 100) -> list:
        return checkpointed_fit(self, graphs, max_epochs, tolerance,
                                verbose=verbose,
                                checkpoint_dir=checkpoint_dir,
                                checkpoint_every=checkpoint_every)

    @torch.no_grad()
    def embed_graphs(self, graphs: Sequence[Graph]) -> np.ndarray:
        """Clean-pass graph embeddings in dataset order, with the running
        batch statistics."""
        outs = []
        for chunk, batch, seg in clean_batches(graphs, self.batch_size,
                                               self.device):
            if self.mesh is not None:
                from rlap_tpu_torch.parallel.mesh import shard_graph

                batch = shard_graph(batch, self.mesh)
            _, gemb, _ = self.model(batch, seg, len(chunk), train=False)
            outs.append(gemb[:len(chunk)].cpu().numpy())
        return np.concatenate(outs, axis=0)

    def evaluate(self, graphs: Sequence[Graph], labels, seed: int = 0) -> dict:
        return probe_graphs(self.embed_graphs(graphs), labels, seed,
                            self.device)


def clean_batches(graphs: Sequence[Graph], batch_size: int, device):
    """Dataset-order unions of `batch_size` graphs, each padded to its own
    sizes rounded up to 128 nodes and 256 edges: (chunk, batch, seg)."""
    for start in range(0, len(graphs), batch_size):
        chunk = list(graphs[start:start + batch_size])
        ncap = ((sum(g.num_nodes for g in chunk) + 127) // 128) * 128
        ecap = ((sum(int(g.num_edges) for g in chunk) + 255) // 256) * 256
        batch, seg = G.block_diagonal(chunk, node_capacity=ncap,
                                      edge_capacity=ecap,
                                      feature_dim=FEATURELESS_DIM,
                                      device=device)
        yield chunk, batch, seg


def probe_graphs(x: np.ndarray, labels, seed: int, device) -> dict:
    """The linear probe on graph embeddings, split 0.8 / 0.1 / 0.1, run
    on `device`."""
    from rlap_tpu_torch.eval.linear_probe import lr_evaluate
    from rlap_tpu_torch.eval.split import get_split

    split = get_split(len(x), 0.8, 0.1, seed=seed)
    num_classes = int(np.max(labels)) + 1
    return lr_evaluate(torch.as_tensor(x, device=device), labels, split,
                       num_classes=num_classes)
