"""Graph diffusion augmentors: personalized PageRank and Markov diffusion
(counterpart of `rlap_tpu/augment/diffusion.py`).

S = alpha (I - (1 - alpha) T)^-1 with T = D^-1/2 A D^-1/2 is taken as a
fixed-depth Neumann series, each step one `ops/spmm.py::spmm` of the
dense [n, n] S over T's nonzero entries, T kept sparse (the JAX package
takes dense n x n products instead: n^3 FLOPs a step against nnz(T) n),
then sparsified row by row into the graph's edge budget: the top k =
capacity // n entries of each row that are at least eps. The Markov
diffusion keeps its dense products.

While a profiler records (`utils/tracing.py`), each augmentor's view is a
span `diffusion.build`, holding `diffusion.rlap` (rLap + PPR only),
`diffusion.ppr` (the series) and `diffusion.topk`; the counters are
`diffusion.builds` and `diffusion.spmm_edges` (nnz(T) x steps), and
`augment/base.py`'s `CachedAugmentor` counts `diffusion.cache_hits`.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.augment.base import Augmentor, CachedAugmentor
from rlap_tpu_torch.augment.rlap import RLap
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.ops.spmm import spmm
from rlap_tpu_torch.utils import tracing

# rows sorted at a time by `dense_to_graph`: bounds the sort's buffers to
# a few times ROW_BLOCK x n
ROW_BLOCK = 4096


def _sym_norm_dense(g: Graph, add_self_loop: bool = True) -> torch.Tensor:
    a = G.to_dense(g)
    if add_self_loop:
        a = a + torch.eye(g.num_nodes, dtype=a.dtype, device=a.device)
    deg = a.sum(1)
    dinv = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)),
                       torch.zeros_like(deg))
    return a * dinv[:, None] * dinv[None, :]


def _sym_norm_sparse(g: Graph, add_self_loop: bool = True) -> Graph:
    """`_sym_norm_dense`'s T as its nonzero entries, for `spmm`: entry
    (i, j) is an edge j -> i, so that `spmm(t, s)` is T S. The same
    arithmetic: A's duplicate edges summed, with `add_self_loop` one more
    on every diagonal entry (A + I, so a self-loop present gains 1), the
    degrees A's row sums, each entry (a_ij d_i^-1/2) d_j^-1/2."""
    n = g.num_nodes
    live = (g.senders < n) & (g.receivers < n)
    rows, cols, w = g.senders[live], g.receivers[live], g.weights[live]
    if add_self_loop:
        ids = torch.arange(n, device=g.device)
        rows, cols = torch.cat([rows, ids]), torch.cat([cols, ids])
        w = torch.cat([w, torch.ones(n, dtype=w.dtype, device=w.device)])
    key, inv = torch.unique(rows * (n + 1) + cols, return_inverse=True)
    a = torch.zeros(key.shape[0], dtype=w.dtype,
                    device=w.device).index_add_(0, inv, w)
    rows, cols = key // (n + 1), key % (n + 1)
    deg = torch.zeros(n, dtype=a.dtype, device=a.device).index_add_(0, rows,
                                                                   a)
    dinv = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)),
                       torch.zeros_like(deg))
    return Graph(senders=cols, receivers=rows,
                 weights=a * dinv[rows] * dinv[cols], num_nodes=n)


def compute_ppr_dense(g: Graph, alpha: float = 0.2, iters: int = 32,
                      add_self_loop: bool = True) -> torch.Tensor:
    """S = alpha sum_k ((1 - alpha) T)^k by `iters` steps of
    S <- alpha I + (1 - alpha) T S from S = alpha I: each step one `spmm`
    of S over T's nonzero entries, weighted (1 - alpha) T, then alpha
    added to the diagonal in place. S is dense [n, n]; T never is."""
    with tracing.annotate("diffusion.ppr"):
        t = _sym_norm_sparse(g, add_self_loop)
        w = (1 - alpha) * t.weights
        tracing.count("diffusion.spmm_edges", t.edge_capacity * iters)
        s = torch.eye(g.num_nodes, dtype=w.dtype, device=w.device).mul_(
            alpha)
        for _ in range(iters):
            s = spmm(t, s, edge_weights=w)
            s.diagonal().add_(alpha)
        return s


def compute_markov_dense(g: Graph, alpha: float = 0.05, order: int = 16,
                         add_self_loop: bool = True) -> torch.Tensor:
    """The mean of the first `order` powers of the lazy walk
    W = alpha I + (1 - alpha) T."""
    t = _sym_norm_dense(g, add_self_loop)
    eye = torch.eye(g.num_nodes, dtype=t.dtype, device=t.device)
    w = alpha * eye + (1 - alpha) * t
    p, acc = eye, torch.zeros_like(eye)
    for _ in range(order):
        p = w @ p
        acc = acc + p
    return acc / order


def _row_top_k(s: torch.Tensor, k: int):
    """The k largest entries of each row, ordered by value descending and,
    among equal values, by column ascending (the order of
    `jax.lax.top_k`): a stable descending sort, ROW_BLOCK rows at a time.
    Returns (values, columns), each [n, k]."""
    vals, idx = [], []
    for start in range(0, s.shape[0], ROW_BLOCK):
        v, i = torch.sort(s[start:start + ROW_BLOCK], dim=1,
                          descending=True, stable=True)
        vals.append(v[:, :k])
        idx.append(i[:, :k])
    return torch.cat(vals), torch.cat(idx)


def dense_to_graph(s: torch.Tensor, g: Graph, eps: float = 1e-4,
                   edge_capacity: Optional[int] = None) -> Graph:
    """Sparsify a dense diffusion matrix into a padded Graph with g's
    features and node mask: per row the top k = capacity // n entries
    (at least 1, at most n) that are >= eps and join real nodes, then
    sorted by (sender, receiver)."""
    with tracing.annotate("diffusion.topk"):
        n = g.num_nodes
        cap = edge_capacity or g.edge_capacity
        k = max(min(cap // n, n), 1)
        vals, idx = _row_top_k(s, k)
        dev = s.device
        senders = torch.arange(n, device=dev)[:, None].expand(n, k) \
            .reshape(-1)
        receivers = idx.reshape(-1)
        weights = vals.reshape(-1).to(g.weights.dtype)
        live = weights >= eps
        if g.node_mask is not None:
            live = live & g.node_mask[senders] & g.node_mask[receivers]
        out = Graph(senders=torch.where(live, senders, n),
                    receivers=torch.where(live, receivers, n),
                    weights=torch.where(live, weights,
                                        torch.zeros_like(weights)),
                    num_nodes=n, x=g.x, node_mask=g.node_mask)
        if n * k > cap:
            out = out.replace(senders=out.senders[:cap],
                              receivers=out.receivers[:cap],
                              weights=out.weights[:cap])
        return G.sort_edges(G.with_capacity(out, cap))


@contextlib.contextmanager
def _build():
    """The span and count of one diffusion view's build."""
    with tracing.annotate("diffusion.build"):
        tracing.count("diffusion.builds", 1)
        yield


def ppr_diffusion_graph(g: Graph, alpha: float = 0.2, eps: float = 1e-4,
                        iters: int = 32, add_self_loop: bool = True,
                        edge_capacity: Optional[int] = None) -> Graph:
    s = compute_ppr_dense(g, alpha=alpha, iters=iters,
                          add_self_loop=add_self_loop)
    return dense_to_graph(s, g, eps=eps, edge_capacity=edge_capacity)


class PPRDiffusion(Augmentor):
    def __init__(self, alpha: float = 0.2, eps: float = 1e-4,
                 iters: int = 32, add_self_loop: bool = True,
                 edge_capacity: Optional[int] = None):
        self.alpha, self.eps = alpha, eps
        self.iters, self.add_self_loop = iters, add_self_loop
        self.edge_capacity = edge_capacity

    def augment(self, g: Graph, key: torch.Generator) -> Graph:
        with _build():
            return ppr_diffusion_graph(g, self.alpha, self.eps, self.iters,
                                       self.add_self_loop,
                                       self.edge_capacity)


class MarkovDiffusion(Augmentor):
    def __init__(self, alpha: float = 0.05, order: int = 16,
                 eps: float = 1e-4, add_self_loop: bool = True,
                 edge_capacity: Optional[int] = None):
        self.alpha, self.order, self.eps = alpha, order, eps
        self.add_self_loop = add_self_loop
        self.edge_capacity = edge_capacity

    def augment(self, g: Graph, key: torch.Generator) -> Graph:
        with _build():
            s = compute_markov_dense(g, self.alpha, self.order,
                                     self.add_self_loop)
            return dense_to_graph(s, g, eps=self.eps,
                                  edge_capacity=self.edge_capacity)


def _restrict_to_first(out: Graph, perm: torch.Tensor, size: int) -> Graph:
    keep = torch.zeros(out.num_nodes, dtype=torch.bool, device=out.device)
    keep[perm[:size]] = True
    return G.induced_subgraph(out, keep)


class PPRDiffusionSubGraph(Augmentor):
    """PPR, then the subgraph induced by a random subset of at most
    `sub_graph_size` nodes (ids kept, not relabelled)."""

    def __init__(self, alpha: float = 0.2, eps: float = 1e-4,
                 add_self_loop: bool = True, sub_graph_size: int = 8192,
                 iters: int = 32):
        self.alpha, self.eps = alpha, eps
        self.add_self_loop = add_self_loop
        self.sub_graph_size = sub_graph_size
        self.iters = iters

    def augment(self, g: Graph, key: torch.Generator) -> Graph:
        with _build():
            out = ppr_diffusion_graph(g, self.alpha, self.eps, self.iters,
                                      self.add_self_loop)
        if g.num_nodes <= self.sub_graph_size:
            return out
        perm = torch.randperm(g.num_nodes, generator=key, device=g.device)
        return _restrict_to_first(out, perm, self.sub_graph_size)


class RLapPPRDiffusion(Augmentor):
    """rLap with its weights kept, then PPR on the Schur complement (no
    self-loops added: eliminated nodes are isolated rows of T), sparsified
    into the input's edge capacity. Views are computed on `device`."""

    def __init__(self, frac: float, o_v: str = "random", o_n: str = "asc",
                 alpha: float = 0.2, eps: float = 1e-4, iters: int = 32,
                 device=None):
        self.rlap = RLap(frac, o_v=o_v, o_n=o_n, keep_weights=True,
                         device=resolve_device(device))
        self.alpha, self.eps, self.iters = alpha, eps, iters

    def augment(self, g: Graph, key: torch.Generator) -> Graph:
        with _build():
            with tracing.annotate("diffusion.rlap"):
                sc = self.rlap(g, key)
            return ppr_diffusion_graph(sc, self.alpha, self.eps, self.iters,
                                       add_self_loop=False,
                                       edge_capacity=g.edge_capacity)


def rlap_ppr_diffusion_cached(frac: float, refresh_every: int = 50,
                              **kw) -> CachedAugmentor:
    return CachedAugmentor(RLapPPRDiffusion(frac, **kw),
                           refresh_every=refresh_every)
