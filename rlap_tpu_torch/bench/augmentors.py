"""Augmentor latency and memory benchmark (counterpart of
`rlap_tpu/bench/augmentors.py`).

For each augmentor of the registry: wall-clock latency of a view of one
graph (node level) and, optionally, of a block-diagonal batch of graphs
(graph level), each call timed to a synchronisation of the card; edges per
second; the change in allocated device memory over the timed calls; and
the device memory one call needs at its peak, from the caching
allocator's statistics: the graph's bytes (`hbm_args_bytes`), what the
call leaves allocated (`hbm_out_bytes`), and what it held beyond that at
its peak (`hbm_temp_bytes`). On the CPU the memory fields are None and
`hbm_note` says why.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from rlap_tpu_torch.augment.registry import (AUGMENTOR_NAMES,
                                             make_augmentor_pair)
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.core.graph import Graph

CPU_NOTE = "graph on the CPU: device memory is measured on the card only"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _graph_bytes(g: Graph) -> int:
    return sum(t.numel() * t.element_size()
               for t in (g.senders, g.receivers, g.weights, g.x, g.node_mask)
               if t is not None)


def _peak_hbm(aug, g: Graph, key: torch.Generator) -> dict:
    """Device memory of one call, from `reset_peak_memory_stats` and
    `max_memory_allocated` around it: peak = the graph + the call's
    output + its temporaries at their peak."""
    dev = g.device
    if dev.type != "cuda":
        return {"peak_hbm_bytes": None, "hbm_note": CPU_NOTE}
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    out = aug(g, key)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - before
    held = torch.cuda.memory_allocated(dev) - before
    del out
    args = _graph_bytes(g)
    return {"peak_hbm_bytes": args + peak, "hbm_args_bytes": args,
            "hbm_out_bytes": held, "hbm_temp_bytes": peak - held}


def bench_augmentor(aug, g: Graph, repeats: int = 10,
                    seed: int = 0) -> Dict[str, float]:
    """One warm-up call, then `repeats` timed calls on fresh keys, on the
    graph's device."""
    dev = g.device
    key = rng.key(seed, device=dev)
    aug(g, key)
    _sync(dev)
    m0 = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
    times = []
    for i in range(repeats):
        k = rng.fold_in(key, i + 1)
        t0 = time.perf_counter()
        out = aug(g, k)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    m1 = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
    e = int(g.edge_mask.sum())
    mean = float(np.mean(times))
    res = {
        "latency_ms_mean": mean * 1e3,
        "latency_ms_std": float(np.std(times)) * 1e3,
        "edges_per_s": e / mean if mean > 0 else float("inf"),
        "mem_delta_bytes": None if m0 is None else m1 - m0,
    }
    res.update(_peak_hbm(aug, g, key))
    return res


def bench_all(g: Graph, names: Sequence[str] = AUGMENTOR_NAMES,
              fraction: float = 0.2, repeats: int = 10,
              graphs: Optional[Sequence[Graph]] = None,
              logger=None) -> Dict[str, Dict[str, float]]:
    """Node-level benchmarks of each registry name on `g`, on its device;
    with `graphs`, a graph-level one on their block-diagonal union too
    (`"<name>/batch"`, half the repeats). Each result is logged as an
    `augmentor_bench` event when a `MetricsLogger` is given."""
    dev = g.device
    batch = None
    if graphs is not None:
        batch, _ = G.block_diagonal(
            list(graphs), node_capacity=sum(gg.num_nodes for gg in graphs),
            edge_capacity=sum(int(gg.num_edges) for gg in graphs),
            device=dev)
    results = {}
    for name in names:
        a1, _ = make_augmentor_pair(name, fraction, fraction,
                                    num_nodes=g.num_nodes, use_cache=False,
                                    device=dev)
        res = bench_augmentor(a1, g, repeats=repeats)
        results[name] = res
        if logger is not None:
            logger.log("augmentor_bench", augmentor=name, level="node", **res)
        if batch is not None:
            resb = bench_augmentor(a1, batch, repeats=max(repeats // 2, 1))
            results[name + "/batch"] = resb
            if logger is not None:
                logger.log("augmentor_bench", augmentor=name, level="graph",
                           **resb)
    return results
