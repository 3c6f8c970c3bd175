"""Synthetic graph generators, on a device.

Counterpart of `rlap_tpu/data/synthetic.py`. The numpy draws are the JAX
package's, line for line, so for one seed the graphs are equal array for
array; only the final `Graph` is built on `device` (the card by default).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.core.graph import Graph


def barabasi_albert(n: int, m: int, seed: int = 0,
                    edge_capacity: Optional[int] = None,
                    device=None) -> Graph:
    """Undirected BA preferential-attachment graph as a symmetric Graph."""
    rng = np.random.default_rng(seed)
    targets = np.arange(m, dtype=np.int64)
    rep = np.empty(2 * m * max(n - m, 1), dtype=np.int64)
    pos = 0
    src = np.empty(m * max(n - m, 1), dtype=np.int64)
    dst = np.empty(m * max(n - m, 1), dtype=np.int64)
    e = 0
    for v in range(m, n):
        k = len(targets)
        src[e:e + k] = v
        dst[e:e + k] = targets
        e += k
        rep[pos:pos + k] = targets
        rep[pos + k:pos + 2 * k] = v
        pos += 2 * k
        targets = rng.choice(rep[:pos], size=m)
    pairs = np.unique(np.stack([np.concatenate([src[:e], dst[:e]]),
                                np.concatenate([dst[:e], src[:e]])], 1),
                      axis=0)
    return Graph.from_edges(pairs[:, 0], pairs[:, 1], num_nodes=n,
                            edge_capacity=edge_capacity, device=device)


def erdos_renyi(n: int, p: float, seed: int = 0,
                edge_capacity: Optional[int] = None, device=None) -> Graph:
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    a = np.triu(a, 1)
    s, r = np.nonzero(a | a.T)
    return Graph.from_edges(s, r, num_nodes=n, edge_capacity=edge_capacity,
                            device=device)


def sbm(n: int, num_blocks: int, p_in: float, p_out: float, seed: int = 0,
        edge_capacity: Optional[int] = None, device=None):
    """Stochastic block model. Returns (Graph, labels[int32 n] numpy)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_blocks, size=n).astype(np.int32)
    same = labels[:, None] == labels[None, :]
    prob = np.where(same, p_in, p_out)
    a = rng.random((n, n)) < prob
    a = np.triu(a, 1)
    s, r = np.nonzero(a | a.T)
    g = Graph.from_edges(s, r, num_nodes=n, edge_capacity=edge_capacity,
                         device=device)
    return g, labels


def synthetic_node_dataset(n: int = 512, num_classes: int = 4,
                           feature_dim: int = 64, p_in: float = 0.05,
                           p_out: float = 0.005, noise: float = 0.6,
                           seed: int = 0,
                           edge_capacity: Optional[int] = None,
                           device=None):
    """SBM graph + noisy class-indicator features, row-normalised.

    Returns (Graph with .x, labels numpy).
    """
    rng = np.random.default_rng(seed + 1)
    g, labels = sbm(n, num_classes, p_in, p_out, seed=seed,
                    edge_capacity=edge_capacity, device=device)
    centers = rng.normal(size=(num_classes, feature_dim)).astype(np.float32)
    x = centers[labels] + noise * rng.normal(size=(n, feature_dim)).astype(
        np.float32)
    x = x / np.maximum(np.abs(x).sum(axis=1, keepdims=True), 1e-12)
    return g.replace(x=torch.as_tensor(x, device=resolve_device(device))), \
        labels


def synthetic_graph_dataset(num_graphs: int = 64, n_lo: int = 10,
                            n_hi: int = 30, num_classes: int = 2,
                            feature_dim: int = 8, seed: int = 0,
                            device=None):
    """A TU-style list of small graphs with graph-level labels: class 0 are
    sparse ER graphs, class 1 denser ones, so density carries the label.
    Returns (list of Graph with .x = ones, labels[int32] numpy)."""
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)
    graphs, labels = [], []
    for i in range(num_graphs):
        y = i % num_classes
        n = int(rng.integers(n_lo, n_hi))
        p = 0.12 + 0.25 * y / max(num_classes - 1, 1)
        g = erdos_renyi(n, p, seed=int(rng.integers(1 << 31)), device=dev)
        graphs.append(g.replace(x=torch.ones((n, feature_dim),
                                             dtype=torch.float32,
                                             device=dev)))
        labels.append(y)
    return graphs, np.asarray(labels, np.int32)
