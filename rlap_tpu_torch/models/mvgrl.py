"""MVGRL: graph-to-local (G2L) contrast with two dedicated encoders
(counterpart of `rlap_tpu/models/mvgrl.py`).

One GCN encoder per view with a per-channel PReLU shared across its
layers; summaries project(sigmoid(mean(z))); corruption by shuffling the
rows of the features through the same encoders; the JSD G2L loss. When
the augmentor is a diffusion and the graph has more than `subsample`
nodes, both views are restricted to one random node subset of at least
`subsample` nodes, as a node mask. Evaluation embeds z1 + z2 of a view
pair drawn from pinned keys.

While a profiler records (`utils/tracing.py`), `train_epoch` is a span
`trainer.step` holding GRACE's phases, `trainer.views` (with
`mvgrl.subsample` inside), `.forward`, `.loss`, `.backward`,
`.optimizer` and `.loss_readback`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.models.common import (checkpointed_fit, init_generator,
                                          torch_adam)
from rlap_tpu_torch.nn.gcn import GCNConv
from rlap_tpu_torch.nn.layers import _dense
from rlap_tpu_torch.objectives.contrast import DualBranchContrast
from rlap_tpu_torch.utils import tracing

EVAL_SEED = 0x5EED


class ChannelPReLU(nn.Module):
    """PReLU with one slope per channel, initialised to 0.25."""

    def __init__(self, num_channels: int, init_slope: float = 0.25):
        super().__init__()
        self.slope = nn.Parameter(torch.full((num_channels,), init_slope))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.slope * x)


class DedicatedGCN(nn.Module):
    """num_layers x (GCNConv -> ChannelPReLU), the activation shared by
    all layers."""

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * num_layers
        self.convs = nn.ModuleList(
            GCNConv(dims[i], dims[i + 1], generator=generator)
            for i in range(num_layers))
        self.act = ChannelPReLU(hidden_dim)

    def forward(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = self.act(conv(g, x))
        return x


class MVGRL(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int = 128,
                 num_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder1 = DedicatedGCN(in_dim, hidden_dim, num_layers,
                                     generator)
        self.encoder2 = DedicatedGCN(in_dim, hidden_dim, num_layers,
                                     generator)
        self.project = _dense(hidden_dim, hidden_dim, generator)

    def _summary(self, z: torch.Tensor,
                 node_mask: Optional[torch.Tensor]) -> torch.Tensor:
        if node_mask is None:
            m = z.mean(0, keepdim=True)
        else:
            w = node_mask.to(z.dtype)[:, None]
            m = (z * w).sum(0, keepdim=True) / w.sum().clamp_min(1.0)
        return self.project(torch.sigmoid(m))

    def forward(self, g1: Graph, g2: Graph, perm1: torch.Tensor,
                perm2: torch.Tensor):
        """Node embeddings, summaries, and the embeddings of the features
        with their rows permuted by perm1 and perm2 (the corruption)."""
        z1 = self.encoder1(g1, g1.x)
        z2 = self.encoder2(g2, g2.x)
        z1n = self.encoder1(g1, g1.x[perm1])
        z2n = self.encoder2(g2, g2.x[perm2])
        return (z1, z2, self._summary(z1, g1.node_mask),
                self._summary(z2, g2.node_mask), z1n, z2n)

    def embed(self, g1: Graph, g2: Graph) -> torch.Tensor:
        return self.encoder1(g1, g1.x) + self.encoder2(g2, g2.x)


def subsample_mask(g2: Graph, u: torch.Tensor, size: int) -> torch.Tensor:
    """bool[n]: the nodes with an edge (self-loops aside) in `g2` whose
    uniform u is at least the `size`-th largest score, where a node
    without edges scores -1. Ties at the threshold are all kept, so more
    than `size` nodes can pass."""
    deg = G.degrees(G.remove_self_loops(g2))
    scores = torch.where(deg > 0, u, torch.full_like(u, -1.0))
    thresh = torch.sort(scores).values[-size]
    return scores >= thresh.clamp_min(0.0)


class MVGRLTrainer:
    """MVGRL training on `device` (the card by default)."""

    def __init__(self, aug1, aug2, augmentor_name: str = "rLap",
                 hidden_dim: int = 128, num_layers: int = 2,
                 lr: float = 1e-3, weight_decay: float = 1e-5,
                 subsample: int = 8192, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.aug1, self.aug2 = aug1, aug2
        self.augmentor_name = augmentor_name
        self.subsample = subsample
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        self.lr, self.weight_decay = lr, weight_decay
        self.contrast = DualBranchContrast(loss="jsd", mode="G2L")
        self.key = rng.key(seed, device=self.device)
        self.model: Optional[MVGRL] = None
        self.optimizer: Optional[torch.optim.Adam] = None

    def ensure_init(self, g: Graph) -> None:
        if self.model is not None:
            return
        self.model = MVGRL(g.x.shape[1], self.hidden_dim, self.num_layers,
                           generator=init_generator(self)).to(self.device)
        self.optimizer = torch_adam(self.model.parameters(), self.lr,
                                    self.weight_decay)

    def views(self, g: Graph, keys=None):
        """The view pair. With `keys=None` the keys are split off the
        trainer's (training); evaluation passes pinned keys, so that
        repeated embeddings see the same views."""
        if keys is None:
            self.key, k1, k2, k3 = rng.split(self.key, 4)
        else:
            k1, k2, k3 = keys
        with tracing.annotate("trainer.views"):
            g1 = self.aug1(g, k1)
            g2 = self.aug2(g, k2)
            if ("diffusion" in self.augmentor_name.lower()
                    and g.num_nodes > self.subsample):
                with tracing.annotate("mvgrl.subsample"):
                    u = torch.rand(g.num_nodes, generator=k3,
                                   device=g.device)
                    keep = subsample_mask(g2, u, self.subsample)
                    nm = keep if g.node_mask is None else keep & g.node_mask
                    g1 = G.induced_subgraph(g1, keep).replace(node_mask=nm)
                    g2 = G.induced_subgraph(g2, keep).replace(node_mask=nm)
            return g1, g2

    def corruption(self, n: int):
        """Two row permutations, from a key split off the trainer's."""
        self.key, kc = rng.split(self.key)
        return tuple(torch.randperm(n, generator=k, device=self.device)
                     for k in rng.split(kc))

    def train_step(self, g1: Graph, g2: Graph, perm1: torch.Tensor,
                   perm2: torch.Tensor) -> float:
        self.ensure_init(g1)
        self.optimizer.zero_grad(set_to_none=True)
        with tracing.annotate("trainer.forward"):
            z1, z2, gl1, gl2, z1n, z2n = self.model(g1, g2, perm1, perm2)
        with tracing.annotate("trainer.loss"):
            loss = self.contrast(h1=z1, h2=z2, g1=gl1, g2=gl2, h3=z1n,
                                 h4=z2n, node_mask=g1.node_mask)
        with tracing.annotate("trainer.backward"):
            loss.backward()
        with tracing.annotate("trainer.optimizer"):
            self.optimizer.step()
        with tracing.annotate("trainer.loss_readback"):
            return float(loss.detach())

    def train_epoch(self, g: Graph) -> float:
        with tracing.annotate("trainer.step"):
            g1, g2 = self.views(g.to(self.device))
            return self.train_step(g1, g2, *self.corruption(g.num_nodes))

    def fit(self, g: Graph, max_epochs: int = 2000, tolerance: int = 50,
            verbose: bool = False, checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 100) -> list:
        return checkpointed_fit(self, g, max_epochs, tolerance,
                                verbose=verbose,
                                checkpoint_dir=checkpoint_dir,
                                checkpoint_every=checkpoint_every)

    @torch.no_grad()
    def embed(self, g: Graph,
              key: Optional[torch.Generator] = None) -> torch.Tensor:
        """z1 + z2 on the view pair of the keys split off `key` (default
        a fixed one): repeated calls embed the same views, and the
        trainer's key is not touched."""
        if key is None:
            key = rng.key(EVAL_SEED, device=self.device)
        g1, g2 = self.views(g.to(self.device), keys=rng.split(key, 3))
        return self.model.embed(g1, g2)

    def evaluate(self, g: Graph, labels, seed: int = 0) -> dict:
        from rlap_tpu_torch.eval.linear_probe import lr_evaluate
        from rlap_tpu_torch.eval.split import get_split

        z = self.embed(g)
        split = get_split(g.num_nodes, 0.1, 0.8, seed=seed)
        num_classes = int(np.max(np.asarray(labels))) + 1
        return lr_evaluate(z, labels, split, num_classes=num_classes)
