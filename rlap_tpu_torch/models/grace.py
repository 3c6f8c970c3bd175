"""GRACE: local-to-local graph contrastive learning (counterpart of
`rlap_tpu/models/grace.py`).

A shared GCN encoder and projection head over two augmented views,
dual-branch InfoNCE, Adam with L2 decay, early stopping on the train loss,
then a linear probe on the clean graph's embeddings. On the card the loss
goes through the fused InfoNCE kernels.

With a `mesh` (`rlap_tpu_torch.parallel`), every rank of the mesh runs
the trainer: the encoder aggregates over the edge shards of the mesh's
"data" axis, and the parameters, the embeddings and the loss are
replicated.

While a profiler records (`utils/tracing.py`), `train_epoch` is a span
`trainer.step` holding `trainer.views`, `trainer.forward`, `trainer.loss`,
`trainer.backward`, `trainer.optimizer` and `trainer.loss_readback` (the
step's one sync), in that order. `zero_grad(set_to_none=True)` drops
references and launches nothing; it stays at the step's start, outside
the spans, so that no gradient left by another caller enters a step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.models.common import (checkpointed_fit, init_generator,
                                          torch_adam)
from rlap_tpu_torch.nn.gcn import GCNEncoder, ProjectionHead
from rlap_tpu_torch.objectives.contrast import DualBranchContrast
from rlap_tpu_torch.utils import tracing


class GRACE(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int = 128,
                 num_layers: int = 2, proj_dim: int = 128,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        self.encoder = GCNEncoder(in_dim, hidden_dim, num_layers,
                                  generator=generator, mesh=mesh)
        self.project = ProjectionHead(hidden_dim, proj_dim, hidden_dim,
                                      generator=generator)

    def forward(self, g1: Graph, g2: Graph):
        z1 = self.encoder(g1, g1.x)
        z2 = self.encoder(g2, g2.x)
        return self.project(z1), self.project(z2)

    def embed(self, g: Graph) -> torch.Tensor:
        return self.encoder(g, g.x)


class GraceTrainer:
    """GRACE training on `device` (the card by default).

    `pair_augmentor`: an optional `(g, key) -> (g1, g2)` that makes both
    views in one call (e.g. `PairedRLap`); it overrides aug1/aug2.
    `loss="auto"` takes the fused kernels for CUDA tensors and
    `infonce_batched` for CPU tensors.

    `mesh`: a `DeviceMesh` with a "data" axis, every rank of it running
    this trainer with the same arguments. `train_epoch`, `fit`, `embed`
    and `evaluate` take the whole graph on every rank; `views` makes the
    views on the mesh's first rank, sends them to the others (a view made
    on the card by each rank apart could differ in its last bits, and
    then in a sampled edge) and returns this rank's edge slice of each;
    `train_step` takes such slices (or any other edge shards, such as
    `eliminate_sharded`'s) and averages the gradients over the mesh.
    """

    def __init__(self, aug1=None, aug2=None, hidden_dim: int = 128,
                 num_layers: int = 2, lr: float = 1e-3,
                 weight_decay: float = 1e-5, tau: float = 0.2,
                 block_size: int = 1024, seed: int = 0, loss: str = "auto",
                 pair_augmentor=None, device=None, mesh=None):
        if pair_augmentor is None and (aug1 is None or aug2 is None):
            raise ValueError("pass aug1+aug2 or pair_augmentor")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.aug1, self.aug2 = aug1, aug2
        self.pair_augmentor = pair_augmentor
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.lr = lr
        self.weight_decay = weight_decay
        self.contrast = DualBranchContrast(loss=loss, tau=tau,
                                           block_size=block_size)
        self.key = rng.key(seed, device=self.device)
        self.model: Optional[GRACE] = None
        self.optimizer: Optional[torch.optim.Adam] = None

    def ensure_init(self, g: Graph) -> None:
        """Build the model for g's feature width, and its optimizer. The
        weights are drawn on the CPU from a key split off the trainer's,
        so they do not depend on the device."""
        if self.model is not None:
            return
        self.model = GRACE(g.x.shape[1], self.hidden_dim, self.num_layers,
                           self.hidden_dim, generator=init_generator(self),
                           mesh=self.mesh).to(self.device)
        self.optimizer = torch_adam(self.model.parameters(), self.lr,
                                    self.weight_decay)

    def views(self, g: Graph):
        with tracing.annotate("trainer.views"):
            if self.pair_augmentor is not None:
                self.key, k = rng.split(self.key)
                make = lambda: self.pair_augmentor(g, k)
            else:
                self.key, k1, k2 = rng.split(self.key, 3)
                make = lambda: (self.aug1(g, k1), self.aug2(g, k2))
            if self.mesh is None:
                return make()
            from rlap_tpu_torch.parallel.mesh import shard_views

            return shard_views(make, self.mesh, self.device)

    def train_step(self, g1: Graph, g2: Graph) -> float:
        """One Adam step on the given views (with a mesh, this rank's
        shards of them). Returns the loss."""
        self.ensure_init(g1)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        with tracing.annotate("trainer.forward"):
            h1, h2 = self.model(g1, g2)
        with tracing.annotate("trainer.loss"):
            loss = self.contrast(h1, h2, node_mask=g1.node_mask)
        with tracing.annotate("trainer.backward"):
            loss.backward()
            if self.mesh is not None:
                from rlap_tpu_torch.parallel.mesh import average_gradients

                average_gradients(self.model.parameters(), self.mesh)
        with tracing.annotate("trainer.optimizer"):
            self.optimizer.step()
        with tracing.annotate("trainer.loss_readback"):
            return float(loss.detach())

    def train_epoch(self, g: Graph) -> float:
        with tracing.annotate("trainer.step"):
            return self.train_step(*self.views(g.to(self.device)))

    def fit(self, g: Graph, max_epochs: int = 2000, tolerance: int = 50,
            verbose: bool = False, checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 100) -> list:
        """Train with early stopping. With `checkpoint_dir`, saves every
        `checkpoint_every` epochs and at the stop, and resumes from the
        latest checkpoint if there is one (`checkpointed_fit`)."""
        return checkpointed_fit(self, g, max_epochs, tolerance,
                                verbose=verbose,
                                checkpoint_dir=checkpoint_dir,
                                checkpoint_every=checkpoint_every)

    @torch.no_grad()
    def embed(self, g: Graph) -> torch.Tensor:
        g = g.to(self.device)
        if self.mesh is not None:
            from rlap_tpu_torch.parallel.mesh import shard_graph

            g = shard_graph(g, self.mesh)
        return self.model.embed(g)

    def evaluate(self, g: Graph, labels, train_ratio: float = 0.1,
                 test_ratio: float = 0.8, seed: int = 0) -> dict:
        from rlap_tpu_torch.eval.linear_probe import lr_evaluate
        from rlap_tpu_torch.eval.split import get_split

        z = self.embed(g)
        split = get_split(g.num_nodes, train_ratio, test_ratio, seed=seed)
        num_classes = int(np.max(np.asarray(labels))) + 1
        return lr_evaluate(z, labels, split, num_classes=num_classes)
