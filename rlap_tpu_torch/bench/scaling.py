"""Scaling of the distributed rLap: edges per second of
`rlap_tpu_torch.parallel.eliminate_sharded` at world size 1 and at world
size P.

    python -m rlap_tpu_torch.bench.scaling [n] [--world P] [--backend B]
        [--device cpu] [--reps R]

Counterpart of `bench_scaling.py`. On BA(n, m=8, seed 0), n = 8192 by
default, each world size runs in its own spawned ranks
(`parallel/launch.py`) and eliminates t = n/2 nodes with o_v = o_n =
"random": one warm-up call, then `reps` calls on fresh keys, each rank
timing each call on the host clock from a synchronised device to a
synchronised device (host reads and collectives included). A call's time
is that of its slowest rank. Beside them, the world-1 rank times the
single-device `eliminate` on the same graph. Every call must remove
exactly t nodes.

Prints one JSON line: `edges_per_s_1`, `edges_per_s_P`, their `ratio`
(P-rank throughput over 1-rank throughput), `single_device_edges_per_s`,
the ms of each call, `world`, `backend` and the device. Ranks that share
one card, or the host's cores, cannot scale: the ratio then prices the
exchange, not a speed-up.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List

import numpy as np

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.bench import describe, log, sync

M, FRAC = 8, 0.5


def rank_throughput(rank: int, world: int, n: int, reps: int,
                    device: str) -> dict:
    """One rank's call times (ms) of `eliminate_sharded`, and at world 1
    those of the single-device `eliminate` too."""
    from rlap_tpu_torch.core import rng
    from rlap_tpu_torch.data.synthetic import barabasi_albert
    from rlap_tpu_torch.ops.rlap import eliminate
    from rlap_tpu_torch.parallel.mesh import make_mesh, shard_graph
    from rlap_tpu_torch.parallel.partition import partition_edges_by_sender
    from rlap_tpu_torch.parallel.rlap_dist import eliminate_sharded

    dev = resolve_device(device)
    mesh = make_mesh(device=dev)
    g = barabasi_albert(n, M, seed=0, device=dev)
    gs = shard_graph(partition_edges_by_sender(g, world), mesh)
    t = int(FRAC * n)
    key = rng.key(0, device=dev)

    def timed(call) -> List[float]:
        out = []
        for i in range(reps + 1):
            sync(dev)
            t0 = time.perf_counter()
            removed = call(rng.fold_in(key, i))
            sync(dev)
            if removed != t:
                raise AssertionError(f"rank {rank}: removed {removed}, "
                                     f"not {t}")
            out.append(1e3 * (time.perf_counter() - t0))
        return out[1:]

    res = {"sharded_ms": timed(
        lambda k: eliminate_sharded(gs, k, t, mesh)[1])}
    if world == 1:
        res["single_ms"] = timed(lambda k: eliminate(g, k, t)[1])
    res["directed_edges"] = int(g.num_edges)
    return res


def run(n: int = 8192, world: int = 2, backend: str = "gloo", device=None,
        reps: int = 3) -> dict:
    """Measure on `device` (the card by default) and return the result
    that `main` prints."""
    from rlap_tpu_torch.parallel.launch import launch

    dev = resolve_device(device)
    per_world = {}
    for p in (1, world):
        ranks = launch(rank_throughput, p, args=(n, reps, str(dev)),
                       backend=backend)
        slowest = np.max([r["sharded_ms"] for r in ranks], axis=0)
        per_world[p] = (ranks, [float(v) for v in slowest])
    edges = per_world[1][0][0]["directed_edges"]
    single = per_world[1][0][0]["single_ms"]

    def eps(ms):
        return edges / (float(np.mean(ms)) / 1e3)

    e1, ep = eps(per_world[1][1]), eps(per_world[world][1])
    log(f"eliminate_sharded: {e1:,.0f} edges/s at 1 rank, {ep:,.0f} at "
        f"{world}; eliminate {eps(single):,.0f}")
    return {"metric": "rlap_sharded_edges_per_s", "edges_per_s_1": e1,
            "edges_per_s_P": ep, "ratio": ep / e1,
            "single_device_edges_per_s": eps(single),
            "ms_per_call_1": per_world[1][1],
            "ms_per_call_P": per_world[world][1],
            "single_device_ms_per_call": single, "world": world,
            "backend": backend, "n": n, "m": M, "t": int(FRAC * n),
            "directed_edges": edges, **describe(dev)}


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8192)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the host; the card by default")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, args.world, args.backend, args.device,
                         args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
