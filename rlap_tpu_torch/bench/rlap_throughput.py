"""rLap throughput: edges per second of `rlap_tpu_torch.ops.rlap.eliminate`
against the sequential C++ oracle.

    python -m rlap_tpu_torch.bench.rlap_throughput [n] [--device D] [--reps R]

Counterpart of `bench.py` (without its roofline model, which priced TPU
primitives). On BA(n, m=8, seed 0), n = 100000 by default (1.6M directed
edges), eliminate t = n/2 nodes with o_v = o_n = "random":

* baseline: the median of 5 runs of the single-threaded oracle
  (`rlap_tpu_torch.native`, the reference's algorithm) on the host;
* the port: one warm-up call, then `reps` calls on fresh keys, each timed
  on the host clock from a synchronised card to a synchronised card. The
  elimination reads a count back to the host once a round, so this is the
  time a caller waits for a view, host time included.

Every call must remove exactly min(t, n - 1) nodes. Diagnostics go to
stderr; the last line of stdout is one JSON object with `bench.py`'s keys
(`metric` "rlap_edges_per_s", `value`, `unit`, `vs_baseline`) and
`ms_per_call`, `rounds`, `removed`, `oracle_s`, `device`. Without
`--device cpu` it runs on the card and raises without one; on the CPU the
times say nothing about the card.
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
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.data.synthetic import barabasi_albert
from rlap_tpu_torch.native import live_edges, oracle_approximate_cholesky
from rlap_tpu_torch.ops.rlap import eliminate

M, FRAC, ORACLE_RUNS = 8, 0.5, 5


def run(n: int = 100_000, device=None, reps: int = 5) -> dict:
    """Measure at BA(n, m=8) on `device` (the card by default) and return
    the result that `main` prints."""
    dev = resolve_device(device)
    g = barabasi_albert(n, M, seed=0, device=dev)
    e_live = int(g.num_edges)
    t = int(FRAC * n)
    want = min(t, n - 1)
    log(f"device {dev}: BA(n={n}, m={M}): {e_live} directed edges, "
        f"removing {t} nodes")

    ei, _w = live_edges(g)
    oracle_s = []
    for i in range(ORACLE_RUNS):
        t0 = time.perf_counter()
        oracle_approximate_cholesky(ei, None, n, t, o_v="random",
                                    o_n="random", seed=i)
        oracle_s.append(time.perf_counter() - t0)
    base_eps = e_live / float(np.median(oracle_s))
    log(f"oracle (host, sequential): median {np.median(oracle_s):.3f} s of "
        f"{oracle_s} -> {base_eps:,.0f} edges/s")

    key = rng.key(0, device=dev)
    removed, rounds, call_s = [], [], []
    for i in range(reps + 1):
        sync(dev)
        t0 = time.perf_counter()
        _out, rem, rnd = eliminate(g, rng.fold_in(key, i), t, o_v="random",
                                   o_n="random")
        sync(dev)
        dt = time.perf_counter() - t0
        if rem != want:
            raise AssertionError(f"call {i} removed {rem} nodes, not {want}")
        if i == 0:
            log(f"warm-up call: {dt * 1e3:.1f} ms, {rnd} rounds")
            continue
        removed.append(rem)
        rounds.append(rnd)
        call_s.append(dt)
    ms = 1e3 * float(np.mean(call_s))
    eps = e_live / (ms / 1e3)
    log(f"eliminate: {ms:.1f} ms/call of {[1e3 * s for s in call_s]} -> "
        f"{eps:,.0f} edges/s, rounds {rounds}")
    return {"metric": "rlap_edges_per_s", "value": eps, "unit": "edges/s",
            "vs_baseline": eps / base_eps, "oracle_edges_per_s": base_eps,
            "ms_per_call": ms, "call_ms": [1e3 * s for s in call_s],
            "rounds": rounds, "removed": removed[-1], "oracle_s": oracle_s,
            "n": n, "m": M, "t": t, "directed_edges": e_live,
            **describe(dev)}


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=100_000)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the host; the card by default")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, args.device, args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
