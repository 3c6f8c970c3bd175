"""A toy program for the recipe contract's test, on the port's `Graph`,
keys and `CachedAugmentor`: a DGI-style step on a dense diffusion view
whose weights are not 1, drawn from a key and cached across steps while
the key chain advances, with a corruption permutation drawn each step."""

from __future__ import annotations

import torch
from torch import nn

from rlap_tpu_torch.core import rng
from rlap_tpu_torch.core.graph import Graph


class Diffusion:
    """Personalised PageRank, alpha (I - (1 - alpha) T)^-1, of the graph
    with each directed edge kept with probability 1 - drop (one draw an
    edge from the key), symmetrised, with self-loops, T the symmetric
    normalisation: a view with an edge j -> i of weight S[i, j] for every
    pair."""

    def __init__(self, alpha: float, drop: float):
        self.alpha, self.drop = alpha, drop

    def __call__(self, g: Graph, key: torch.Generator) -> Graph:
        n, dev = g.num_nodes, g.senders.device
        live = g.senders < n
        s, r = g.senders[live], g.receivers[live]
        keep = torch.rand(s.shape[0], generator=key, device=dev) >= self.drop
        a = torch.zeros(n, n, device=dev)
        a[r[keep], s[keep]] = 1.0
        eye = torch.eye(n, device=dev)
        a = torch.maximum(a, a.T) + eye
        d = a.sum(1).rsqrt()
        t = d[:, None] * a * d[None, :]
        diff = self.alpha * torch.linalg.inv(eye - (1 - self.alpha) * t)
        rows, cols = torch.meshgrid(torch.arange(n, device=dev),
                                    torch.arange(n, device=dev),
                                    indexing="ij")
        return Graph(senders=cols.flatten(), receivers=rows.flatten(),
                     weights=diff.flatten(), num_nodes=n, x=g.x)


def propagate(view: Graph, h: torch.Tensor) -> torch.Tensor:
    """out[i] = sum over edges (j -> i) of w h[j]."""
    msg = view.weights[:, None] * h[view.senders]
    return torch.zeros_like(h).index_add_(0, view.receivers, msg)


class ToyModel(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.lin = nn.Linear(in_dim, hidden_dim, bias=False)
        self.project = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, view: Graph, perm: torch.Tensor) -> torch.Tensor:
        """DGI's loss: the nodes' embeddings against the summary, the
        corrupted ones (feature rows permuted) as negatives."""
        h = self.lin(view.x)
        z, zc = propagate(view, h), propagate(view, h[perm])
        s = self.project(torch.sigmoid(z.mean(0)))
        return (nn.functional.softplus(-(z @ s)).mean()
                + nn.functional.softplus(zc @ s).mean())


class ToyTrainer:
    """Each step: a view from `aug` on a key split off the trainer's, a
    corruption permutation on the next, one Adam step."""

    def __init__(self, aug, in_dim: int, hidden_dim: int, lr: float,
                 seed: int, device):
        self.aug, self.device = aug, device
        self.key = rng.key(seed, device=device)
        self.model = ToyModel(in_dim, hidden_dim).to(device)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr)

    def views(self, g: Graph) -> Graph:
        self.key, k = rng.split(self.key)
        return self.aug(g, k)

    def corruption(self, n: int) -> torch.Tensor:
        """A row permutation, from a key split off the trainer's (as
        MVGRL's: the key is the trainer's, not an argument)."""
        self.key, k = rng.split(self.key)
        return torch.randperm(n, generator=k, device=self.device)

    def train_epoch(self, g: Graph) -> float:
        view = self.views(g)
        perm = self.corruption(g.num_nodes)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.model(view, perm)
        loss.backward()
        self.optimizer.step()
        return float(loss.detach())
