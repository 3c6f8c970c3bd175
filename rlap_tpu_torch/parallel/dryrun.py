"""The multi-rank training path, end to end (counterpart of
`__graft_entry__.dryrun_multichip`).

    python -m rlap_tpu_torch.parallel.dryrun [WORLD] [--backend B] [--n N]
        [--steps S] [--device cpu]
    torchrun --nproc-per-node=P -m rlap_tpu_torch.parallel.dryrun [--n N]

Spawns WORLD ranks (`launch.py`), or runs as one of torchrun's P ranks
(`mesh.init_distributed`: NCCL, one card a rank), over a (replica, data)
mesh: 2 replicas when the world is even and above 2, else 1. Each rank
runs:

1. **The distributed rLap** at BA(4096, m=4): `eliminate_sharded` of
   2048 nodes over the "data" axis, which must remove exactly 2048.
2. **GRACE steps through it**: on BA(n, m=8) with f-wide Gaussian
   features, partitioned by sender block, each step's two views come
   from `eliminate_sharded` (0.2 n nodes each, exactly), coalesced
   shard-locally with unit weights (the rLap augmentor's views), and go
   through `GraceTrainer(mesh=...)`'s `train_step`: the edge-partitioned
   GCN (hidden 128, 2 layers), the InfoNCE loss (the fused kernels on the
   card), Adam on replicated parameters. The losses must be finite and
   equal on every rank.

Returns, and prints as one JSON line, what each rank measured: the times
of the rLap at n=4096, of each step, its views and each view's
elimination, the losses, the InfoNCE kernels' launches, and the device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.parallel.launch import launch
from rlap_tpu_torch.parallel.mesh import (init_distributed, make_mesh_2level,
                                          shard_graph)
from rlap_tpu_torch.parallel.partition import partition_edges_by_sender
from rlap_tpu_torch.parallel.rlap_dist import eliminate_sharded

RLAP_N, RLAP_M = 4096, 4
M, FRAC, HIDDEN, LAYERS = 8, 0.2, 128, 2


def mesh_shape(world: int) -> tuple:
    """(replica, data): two replicas when the world is even and above 2,
    as the JAX dry run does."""
    replica = 2 if world % 2 == 0 and world > 2 else 1
    return replica, world // replica


def _now(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def sharded_view(gs: Graph, key, t: int, mesh) -> tuple:
    """One rLap view of this rank's shard: `eliminate_sharded`, then a
    shard-local coalesce and unit weights on the live edges. Returns
    (view, removed)."""
    out, removed, _overflow = eliminate_sharded(gs, key, t, mesh)
    out = G.coalesce_fast(out)
    return out.replace(weights=out.edge_mask.to(out.weights.dtype)), removed


def features(n: int, f: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


def rank_main(rank: int, world: int, n: int, f: int, steps: int,
              device: str) -> dict:
    """One rank of the dry run (see the module docstring)."""
    from rlap_tpu_torch.augment.feature import FeatureMasking
    from rlap_tpu_torch.data.synthetic import barabasi_albert
    from rlap_tpu_torch.models.grace import GraceTrainer
    from rlap_tpu_torch.ops import infonce_fused as K

    dev = resolve_device(device)
    replica, data = mesh_shape(world)
    mesh = make_mesh_2level(replica, data, device=dev)

    gbig = partition_edges_by_sender(
        barabasi_albert(RLAP_N, RLAP_M, seed=0, device=dev), data)
    t0 = _now(dev)
    _out, removed, overflow = eliminate_sharded(
        shard_graph(gbig, mesh), rng.key(1, device=dev), RLAP_N // 2, mesh)
    rlap_ms = 1e3 * (_now(dev) - t0)
    if removed != RLAP_N // 2 or overflow:
        raise AssertionError(f"rank {rank}: the rLap at n={RLAP_N} removed "
                             f"{removed}, overflow {overflow}")

    g = barabasi_albert(n, M, seed=0, device=dev)
    g = g.replace(x=torch.as_tensor(features(n, f), device=dev))
    gs = shard_graph(partition_edges_by_sender(g, data), mesh)
    t = int(FRAC * n)
    # the trainer's own `views` are not used: the views come sharded
    aug = FeatureMasking(0.0)
    tr = GraceTrainer(aug, aug, hidden_dim=HIDDEN, num_layers=LAYERS,
                      seed=0, device=dev, mesh=mesh)
    key = rng.key(2, device=dev)
    K.reset_launch_counts()
    losses, step_ms, views_ms, view_rlap_ms = [], [], [], []
    for i in range(steps):
        t0 = _now(dev)
        views = []
        for k in rng.split(rng.fold_in(key, i)):
            t1 = _now(dev)
            v, rem = sharded_view(gs, k, t, mesh)
            view_rlap_ms.append(1e3 * (_now(dev) - t1))
            if rem != t:
                raise AssertionError(f"rank {rank}: a view removed {rem} "
                                     f"nodes, not {t}")
            views.append(v)
        t1 = _now(dev)
        losses.append(tr.train_step(*views))
        step_ms.append(1e3 * (_now(dev) - t0))
        views_ms.append(1e3 * (t1 - t0))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"rank {rank}: losses {losses}")
    return {"rank": rank, "mesh": {"replica": replica, "data": data},
            "rlap_n": RLAP_N, "rlap_ms": rlap_ms, "n": n, "f": f,
            "directed_edges": int(g.num_edges), "num_remove": t,
            "losses": losses, "step_ms": step_ms, "views_ms": views_ms,
            "rlap_ms_per_view": view_rlap_ms,
            "infonce_launches": dict(K.launch_counts),
            "params": {k: v.detach().cpu() for k, v in
                       tr.model.state_dict().items()},
            "device": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu"}


def dryrun_multichip(world_size: int = 2, backend: str = "gloo",
                     n: int = RLAP_N, f: int = 128, steps: int = 1,
                     device=None, timeout: float = 900.0) -> dict:
    """Run the dry run on `world_size` spawned ranks over `backend` on
    `device` (the card by default: "nccl" needs a card per rank, "gloo"
    takes the card's tensors too). Returns {"world_size", "backend",
    "ranks": [each rank's result]}; raises if a check fails on any rank,
    or if the ranks' losses or parameters differ."""
    dev = resolve_device(device)
    ranks = launch(rank_main, world_size,
                   args=(n, f, steps, str(dev)), backend=backend,
                   timeout=timeout)
    return summarise(ranks, backend)


def summarise(ranks: list, backend: str) -> dict:
    """The dry run's result from its ranks' results; raises if a rank's
    losses or parameters differ from rank 0's."""
    first = ranks[0]
    for res in ranks[1:]:
        if res["losses"] != first["losses"] or any(
                not torch.equal(res["params"][k], v)
                for k, v in first["params"].items()):
            raise AssertionError(
                f"rank {res['rank']} differs from rank 0: losses "
                f"{res['losses']} against {first['losses']}")
    for res in ranks:
        del res["params"]
    return {"world_size": len(ranks), "backend": backend, "ranks": ranks}


def under_torchrun(n: int, f: int, steps: int, device) -> Optional[dict]:
    """This rank's part of the dry run when torchrun started it: joins the
    group (`init_distributed`), runs `rank_main`, and returns the result
    on rank 0 (None on the others)."""
    import torch.distributed as dist

    world = init_distributed(device)
    res = rank_main(dist.get_rank(), world, n, f, steps,
                    str(resolve_device(device)))
    ranks = [None] * world
    dist.all_gather_object(ranks, res)
    backend = dist.get_backend()
    dist.destroy_process_group()
    return summarise(ranks, backend) if res["rank"] == 0 else None


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("world", type=int, nargs="?", default=2,
                    help="ranks to spawn (ignored under torchrun)")
    ap.add_argument("--backend", default="gloo",
                    help="of the spawned ranks; under torchrun NCCL on "
                    "the card, gloo on the host")
    ap.add_argument("--n", type=int, default=RLAP_N)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the host; the card by default")
    args = ap.parse_args(argv)
    if "LOCAL_RANK" in os.environ:
        res = under_torchrun(args.n, 128, args.steps, args.device)
    else:
        res = dryrun_multichip(args.world, args.backend, args.n,
                               steps=args.steps, device=args.device)
    if res is not None:
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
