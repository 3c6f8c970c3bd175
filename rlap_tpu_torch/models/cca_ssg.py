"""CCA-SSG: feature-decorrelation self-supervised learning (counterpart of
`rlap_tpu/models/cca_ssg.py`).

Both views come from the same augmentor, with self-loops added after
augmentation; a GCN (or MLP) backbone; per-dimension standardised
embeddings and the CCA-SSG loss; a fixed epoch budget; a linear probe on
the clean graph (with self-loops) for evaluation.

The trainer's spans are GRACE's (`models/grace.py`): `trainer.step`
holding `trainer.views`, `trainer.forward`, `trainer.loss`,
`trainer.backward`, `trainer.optimizer` and `trainer.loss_readback`.
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
from rlap_tpu_torch.nn.layers import PReLU, _dense
from rlap_tpu_torch.objectives.cca import cca_ssg_loss, standardize
from rlap_tpu_torch.utils import tracing


class CCAGCN(nn.Module):
    """`num_layers` GCN convolutions without added self-loops, a PReLU
    (`prelu_i`, one slope) after each but the last."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.convs = nn.ModuleList(
            GCNConv(dims[i], dims[i + 1], generator=generator,
                    add_self_loops=False) for i in range(num_layers))
        for i in range(num_layers - 1):
            self.register_parameter(f"prelu_{i}",
                                    nn.Parameter(torch.tensor(0.25)))

    def forward(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = conv(g, x)
            if i < len(self.convs) - 1:
                a = getattr(self, f"prelu_{i}")
                x = torch.where(x >= 0, x, a * x)
        return x


class CCAMLP(nn.Module):
    """The MLP backbone: Dense -> PReLU -> Dense (flax's names)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = _dense(in_dim, hidden_dim, generator)
        self.act = PReLU()
        self.Dense_1 = _dense(hidden_dim, out_dim, generator)

    def forward(self, g: Graph, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(self.act(self.Dense_0(x)))


class CCASSG(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int = 512, out_dim: int = 512,
                 num_layers: int = 2, backbone: str = "gcn",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if backbone == "gcn":
            self.net = CCAGCN(in_dim, hidden_dim, out_dim, num_layers,
                              generator=generator)
        else:
            self.net = CCAMLP(in_dim, hidden_dim, out_dim,
                              generator=generator)

    def forward(self, g1: Graph, g2: Graph):
        return (standardize(self.net(g1, g1.x), g1.node_mask),
                standardize(self.net(g2, g2.x), g2.node_mask))

    def embed(self, g: Graph) -> torch.Tensor:
        return self.net(g, g.x)


class CCASSGTrainer:
    """CCA-SSG training on `device` (the card by default). `aug` is one
    `(g, key) -> Graph` augmentor, applied twice per step."""

    def __init__(self, aug, hidden_dim: int = 512, out_dim: int = 512,
                 num_layers: int = 2, lr: float = 1e-3,
                 weight_decay: float = 0.0, lam: float = 1e-3,
                 backbone: str = "gcn", seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.aug = aug
        self.hidden_dim, self.out_dim = hidden_dim, out_dim
        self.num_layers, self.backbone = num_layers, backbone
        self.lr, self.weight_decay, self.lam = lr, weight_decay, lam
        self.key = rng.key(seed, device=self.device)
        self.model: Optional[CCASSG] = None
        self.optimizer: Optional[torch.optim.Adam] = None
        self._placed: tuple = (None, None)  # (graph given, it on device)

    def ensure_init(self, g: Graph) -> None:
        if self.model is not None:
            return
        self.model = CCASSG(g.x.shape[1], self.hidden_dim, self.out_dim,
                            self.num_layers, self.backbone,
                            generator=init_generator(self)).to(self.device)
        self.optimizer = torch_adam(self.model.parameters(), self.lr,
                                    self.weight_decay)

    def views(self, g: Graph):
        with tracing.annotate("trainer.views"):
            self.key, k1, k2 = rng.split(self.key, 3)
            return (G.add_self_loops(self.aug(g, k1)),
                    G.add_self_loops(self.aug(g, k2)))

    def train_step(self, g1: Graph, g2: Graph) -> float:
        self.ensure_init(g1)
        self.optimizer.zero_grad(set_to_none=True)
        with tracing.annotate("trainer.forward"):
            z1, z2 = self.model(g1, g2)
        with tracing.annotate("trainer.loss"):
            loss = cca_ssg_loss(z1, z2, lam=self.lam,
                                node_mask=g1.node_mask,
                                pre_standardized=True)
        with tracing.annotate("trainer.backward"):
            loss.backward()
        with tracing.annotate("trainer.optimizer"):
            self.optimizer.step()
        with tracing.annotate("trainer.loss_readback"):
            return float(loss.detach())

    def on_device(self, g: Graph) -> Graph:
        """`g` on the trainer's device, the same object each time it is
        given the same `g`: the diffusion functions cache their view on
        the graph object, as the JAX package does."""
        if self._placed[0] is not g:
            self._placed = (g, g.to(self.device))
        return self._placed[1]

    def train_epoch(self, g: Graph) -> float:
        with tracing.annotate("trainer.step"):
            return self.train_step(*self.views(self.on_device(g)))

    def fit(self, g: Graph, max_epochs: int = 100, verbose: bool = False,
            tolerance: int = 10**9, checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 100) -> list:
        """A fixed epoch budget (early stopping off unless `tolerance` is
        given); checkpoint and resume as `checkpointed_fit`."""
        return checkpointed_fit(self, g, max_epochs, tolerance,
                                verbose=verbose,
                                checkpoint_dir=checkpoint_dir,
                                checkpoint_every=checkpoint_every,
                                log_every=10)

    @torch.no_grad()
    def embed(self, g: Graph) -> torch.Tensor:
        return self.model.embed(G.add_self_loops(g.to(self.device)))

    def evaluate(self, g: Graph, labels, train_ratio: float = 0.1,
                 test_ratio: float = 0.8, lr2: float = 1e-2,
                 wd2: float = 1e-4, seed: int = 0) -> dict:
        from rlap_tpu_torch.eval.linear_probe import lr_evaluate
        from rlap_tpu_torch.eval.split import get_split

        z = self.embed(g)
        split = get_split(g.num_nodes, train_ratio, test_ratio, seed=seed)
        num_classes = int(np.max(np.asarray(labels))) + 1
        return lr_evaluate(z, labels, split, num_classes=num_classes,
                           lr=lr2, wd=wd2)
