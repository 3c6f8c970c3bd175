"""BGRL (G2L): bootstrapped, negative-free graph contrast (counterpart of
`rlap_tpu/models/bgrl.py`).

An online GIN encoder with a projection head (Linear -> BatchNorm ->
PReLU -> Dropout) and a predictor of the same shape; a target encoder
that is an EMA (momentum 0.99) of the online one, without gradients; the
loss aligns each node's prediction with the other view's target summary
of its graph (`bootstrap_latent` on `cross_scale_masks_batched`).
Evaluation embeds the clean graphs and concatenates the summary with
itself.

The target is a second copy of the model whose batch-norm buffers are the
online model's own tensors, so it reads the running statistics as they
stand before a step, as the JAX package does. Dropout masks are drawn
from an explicit generator (`dropout_gen`), split off the trainer's key.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.models.common import (checkpointed_fit, init_generator,
                                          make_union_batches, torch_adam)
from rlap_tpu_torch.models.graphcl import (FEATURELESS_DIM, buffers_of,
                                           clean_batches, copy_into,
                                           probe_graphs)
from rlap_tpu_torch.nn.gin import GINConv
from rlap_tpu_torch.nn.layers import (MaskedBatchNorm, PReLU, _dense,
                                      global_add_pool)
from rlap_tpu_torch.objectives.contrast import (bootstrap_latent,
                                                cross_scale_masks_batched)


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Zero each element with probability `rate` and scale the rest by
    1 / (1 - rate); the identity when `rate` is 0."""
    if rate <= 0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class _Head(nn.Module):
    """Linear -> masked BatchNorm -> PReLU, then dropout in training
    (flax's automatic names)."""

    def __init__(self, in_dim: int, hidden_dim: int, dropout: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.Dense_0 = _dense(in_dim, hidden_dim, generator)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(hidden_dim)
        self.PReLU_0 = PReLU()

    def forward(self, x, mask=None, train: bool = True, dropout_gen=None):
        x = self.MaskedBatchNorm_0(self.Dense_0(x), mask=mask,
                                   use_running_average=not train)
        x = self.PReLU_0(x)
        return dropout(x, self.dropout, dropout_gen) if train else x


class BGRLEncoder(nn.Module):
    """GIN convolutions with a shared PReLU and dropout, a masked
    BatchNorm, and the projection head: returns (z, projection(z))."""

    def __init__(self, in_dim: int, hidden_dim: int = 32,
                 num_layers: int = 2, dropout: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        dims = [in_dim] + [hidden_dim] * num_layers
        self.convs = nn.ModuleList(
            GINConv(dims[i], hidden_dim, generator=generator)
            for i in range(num_layers))
        self.act = PReLU()
        self.bn = MaskedBatchNorm(hidden_dim)
        self.projection = _Head(hidden_dim, hidden_dim, dropout, generator)

    def forward(self, g: Graph, x: torch.Tensor, train: bool = True,
                dropout_gen=None):
        for conv in self.convs:
            x = self.act(conv(g, x))
            if train:
                x = dropout(x, self.dropout, dropout_gen)
        z = self.bn(x, mask=g.node_mask, use_running_average=not train)
        return z, self.projection(z, mask=g.node_mask, train=train,
                                  dropout_gen=dropout_gen)


def _masked(g: Graph, h: torch.Tensor) -> torch.Tensor:
    if g.node_mask is None:
        return h
    return torch.where(g.node_mask[:, None], h, torch.zeros_like(h))


class BGRL(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int = 32,
                 num_layers: int = 2, dropout: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = BGRLEncoder(in_dim, hidden_dim, num_layers, dropout,
                                   generator)
        self.predictor = _Head(hidden_dim, hidden_dim, dropout, generator)

    def forward(self, g: Graph, seg, num_graphs: int, train: bool = True,
                dropout_gen=None):
        """The online pass: (z, sum-pooled graph embedding, prediction)."""
        z, h = self.encoder(g, g.x, train=train, dropout_gen=dropout_gen)
        gemb = global_add_pool(_masked(g, z), seg, num_graphs)
        hp = self.predictor(h, mask=g.node_mask, train=train,
                            dropout_gen=dropout_gen)
        return z, gemb, hp

    def target(self, g: Graph, seg, num_graphs: int) -> torch.Tensor:
        """The target pass: the sum-pooled projections, running
        statistics, no dropout."""
        _, h = self.encoder(g, g.x, train=False)
        return global_add_pool(_masked(g, h), seg, num_graphs)


class BGRLTrainer:
    """BGRL training on `device` (the card by default)."""

    _ckpt_extra = ("target_params", "batch_stats")

    def __init__(self, aug1, aug2, hidden_dim: int = 32, num_layers: int = 2,
                 lr: float = 1e-2, weight_decay: float = 0.0,
                 momentum: float = 0.99, batch_size: int = 128,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.aug1, self.aug2 = aug1, aug2
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        self.lr, self.weight_decay = lr, weight_decay
        self.momentum = momentum
        self.batch_size = batch_size
        # the reference's rate; a test may set 0 before the model is built
        self.dropout = 0.2
        self.key = rng.key(seed, device=self.device)
        self.model: Optional[BGRL] = None
        self.target_model: Optional[BGRL] = None
        self.optimizer: Optional[torch.optim.Adam] = None

    @property
    def target_params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone()
                for k, v in self.target_model.named_parameters()}

    @target_params.setter
    def target_params(self, params: Dict[str, torch.Tensor]) -> None:
        copy_into(dict(self.target_model.named_parameters()), params)

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return buffers_of(self.model)

    @batch_stats.setter
    def batch_stats(self, stats: Dict[str, torch.Tensor]) -> None:
        copy_into(dict(self.model.named_buffers()), stats)

    def ensure_init(self, graphs: Sequence[Graph]) -> None:
        """The online model, its optimizer, and the target: a copy of the
        online parameters that shares its batch-norm buffers."""
        if self.model is not None:
            return
        x = graphs[0].x
        in_dim = FEATURELESS_DIM if x is None else x.shape[1]
        self.model = BGRL(in_dim, self.hidden_dim, self.num_layers,
                          self.dropout,
                          generator=init_generator(self)).to(self.device)
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        for name, src in self.model.named_modules():
            if isinstance(src, MaskedBatchNorm):
                tgt = self.target_model.get_submodule(name)
                tgt.mean, tgt.var = src.mean, src.var
        self.optimizer = torch_adam(self.model.parameters(), self.lr,
                                    self.weight_decay)

    def train_step(self, g1: Graph, g2: Graph, seg: torch.Tensor,
                   num_graphs: int, dropout_key: torch.Generator) -> float:
        """One Adam step and EMA update on a batch's two views; the two
        online passes draw their dropout masks from the children of
        `dropout_key`."""
        pos_nodes = cross_scale_masks_batched(
            seg, num_graphs, node_mask=g1.node_mask)[0].T
        with torch.no_grad():
            g1t = self.target_model.target(g1, seg, num_graphs)
            g2t = self.target_model.target(g2, seg, num_graphs)
        r1, r2 = rng.split(dropout_key)
        self.optimizer.zero_grad(set_to_none=True)
        _, _, h1p = self.model(g1, seg, num_graphs, True, r1)
        _, _, h2p = self.model(g2, seg, num_graphs, True, r2)
        loss = 0.5 * (bootstrap_latent(h1p, g2t, pos_nodes)
                      + bootstrap_latent(h2p, g1t, pos_nodes))
        loss.backward()
        self.optimizer.step()
        with torch.no_grad():
            m = self.momentum
            for t, o in zip(self.target_model.parameters(),
                            self.model.parameters()):
                t.mul_(m).add_((1 - m) * o)
        return float(loss.detach())

    def train_epoch(self, graphs: Sequence[Graph], epoch: int = 0) -> float:
        self.ensure_init(graphs)
        total = 0.0
        for batch, seg, ng in make_union_batches(
                graphs, self.batch_size, shuffle_seed=epoch,
                device=self.device, feature_dim=FEATURELESS_DIM):
            self.key, k1, k2, kr = rng.split(self.key, 4)
            total += self.train_step(self.aug1(batch, k1),
                                     self.aug2(batch, k2), seg, ng, kr)
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
        """The online summary of the clean graphs, concatenated with
        itself (the two views of evaluation are both the clean graph)."""
        outs = []
        for chunk, batch, seg in clean_batches(graphs, self.batch_size,
                                               self.device):
            _, gemb, _ = self.model(batch, seg, len(chunk), train=False)
            outs.append(gemb[:len(chunk)].cpu().numpy())
        x = np.concatenate(outs, axis=0)
        return np.concatenate([x, x], axis=1)

    def evaluate(self, graphs: Sequence[Graph], labels, seed: int = 0) -> dict:
        return probe_graphs(self.embed_graphs(graphs), labels, seed,
                            self.device)
