"""Spectral analysis of iterated rLap (counterpart of
`rlap_tpu/bench/spectral.py`): iterate the elimination in `batch_count`
steps of `batch_frac` of the original node count, tracking each step's
largest singular value, count of nodes with an edge and count of directed
edges, mean and std over `num_runs` trajectories; and the edge counts of
PPR diffusion on the graph against PPR on its rLap Schur complements.

The eliminations run on `device` (the card by default); the statistics
are taken on the host from the dense adjacency. The port's generators
differ from JAX's, so the curves agree with the JAX package's in
distribution, not number for number.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.augment.diffusion import ppr_diffusion_graph
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.ops.rlap import approximate_cholesky


def _stats(g: Graph) -> Tuple[float, int, int]:
    d = G.to_dense(g).cpu().numpy()
    sv = float(np.linalg.svd(d, compute_uv=False)[0]) if d.any() else 0.0
    deg = (d > 0).sum(1)
    return sv, int((deg > 0).sum()), int((d > 0).sum())


def iterated_rlap_curves(g: Graph, o_v: str = "random", o_n: str = "random",
                         total_frac: float = 0.5, batch_count: int = 10,
                         num_runs: int = 10, seed: int = 0,
                         device=None) -> Dict[str, np.ndarray]:
    """Arrays [batch_count + 1] of the mean and std of max-SV, node count
    and edge count across `num_runs` trajectories; run r starts from
    `rng.key(seed + r)` and splits a key off it for every step."""
    dev = resolve_device(device)
    g = g.to(dev)
    per_step = int(total_frac / batch_count * g.num_nodes)
    curves = {k: np.zeros((num_runs, batch_count + 1))
              for k in ("max_sv", "nodes", "edges")}
    for run in range(num_runs):
        key = rng.key(seed + run, device=dev)
        cur = g
        for step in range(batch_count + 1):
            if step:
                key, k = rng.split(key)
                cur = approximate_cholesky(cur, k, per_step, o_v=o_v,
                                           o_n=o_n, device=dev)
            sv, nn, ee = _stats(cur)
            curves["max_sv"][run, step] = sv
            curves["nodes"][run, step] = nn
            curves["edges"][run, step] = ee
    out = {}
    for k, arr in curves.items():
        out[f"{k}_mean"] = arr.mean(0)
        out[f"{k}_std"] = arr.std(0)
    return out


def ppr_edge_counts(g: Graph, fractions=(0.1, 0.2, 0.3, 0.4, 0.5),
                    alpha: float = 0.2, eps: float = 1e-4, seed: int = 0,
                    device=None) -> dict:
    """Live edges of PPR diffusion on `g` (`"ppr"`) and, for each
    elimination fraction, of PPR on an rLap Schur complement without
    self-loops (`"rlap_ppr"`, by fraction); one key split per fraction."""
    dev = resolve_device(device)
    g = g.to(dev)
    key = rng.key(seed, device=dev)
    base = ppr_diffusion_graph(g, alpha=alpha, eps=eps)
    out = {"ppr": int(base.edge_mask.sum()), "rlap_ppr": {}}
    for frac in fractions:
        key, k = rng.split(key)
        sc = approximate_cholesky(g, k, int(frac * g.num_nodes), device=dev)
        dif = ppr_diffusion_graph(sc, alpha=alpha, eps=eps,
                                  add_self_loop=False)
        out["rlap_ppr"][frac] = int(dif.edge_mask.sum())
    return out
