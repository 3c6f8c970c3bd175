"""rLap throughput: edges per second of `rlap_tpu_torch.ops.rlap.eliminate`
against the sequential C++ oracle.

    python -m rlap_tpu_torch.bench.rlap_throughput [n] [--device D] [--reps R]

Counterpart of `bench.py`. On BA(n, m=8, seed 0), n = 100000 by default
(1.6M directed edges), eliminate t = n/2 nodes with o_v = o_n = "random":

* baseline: the median of 5 runs of the single-threaded oracle
  (`rlap_tpu_torch.native`, the reference's algorithm) on the host;
* the port: one warm-up call, then `reps` calls on fresh keys, each timed
  on the host clock from a synchronised card to a synchronised card. The
  elimination reads a count back to the host once a round, so this is the
  time a caller waits for a view, host time included; then one more call
  under the profiler (`utils/tracing.traced`), for the card's busy time
  in it;
* the speed-of-light model (`bench/roofline.py`): the primitives' prices
  measured on the same device in the same process (`measure_prices` at a
  table of n and E = the graph's directed edges, the gather and the
  scatter through the C1 and C4 kernels), then the rounds on the same
  graph at the same t replayed and priced; `roofline_fraction` is the
  model's ms over `ms_per_call`: a floor at today's measured prices, not
  a physical ceiling.

Every call must remove exactly min(t, n - 1) nodes. Diagnostics go to
stderr; the last line of stdout is one JSON object with `bench.py`'s keys
(`metric` "rlap_edges_per_s", `value`, `unit`, `vs_baseline`) and
`ms_per_call`, `rounds`, `removed`, `oracle_s`, `device`; the traced
call's `traced_call_ms`, `traced_call_device_busy_ms` and
`traced_call_kernels`; the model's `roofline_ms`, `roofline_fraction`,
`roofline_rounds`, `roofline_breakdown_ms`, `roofline_entry_exit_ms`,
`roofline_by_price_ms` and `roofline_elements` (ms and elements by
primitive), `prices_ns`, `price_fixed_ms` (each price's launch part,
apart from its rate) and `price_checks` (the measurement's size and
reps, and the launches and max abs error of `take` and `scatter_min` in
it); and the host seconds of the measurement, `prices_s`, and of the
replay, `replay_s`. Without
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
from rlap_tpu_torch.bench import roofline as RL
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.data.synthetic import barabasi_albert
from rlap_tpu_torch.native import live_edges, oracle_approximate_cholesky
from rlap_tpu_torch.ops.rlap import eliminate
from rlap_tpu_torch.utils import tracing

M, FRAC, ORACLE_RUNS = 8, 0.5, 5


def _check_removed(out: tuple, want: int, i: int) -> tuple:
    """`eliminate`'s (removed, rounds), once it removed `want` nodes."""
    _view, rem, rnd = out
    if rem != want:
        raise AssertionError(f"call {i} removed {rem} nodes, not {want}")
    return rem, rnd


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
        rem, rnd = _check_removed(eliminate(g, rng.fold_in(key, i), t,
                                            o_v="random", o_n="random"),
                                  want, i)
        sync(dev)
        dt = time.perf_counter() - t0
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

    traced = tracing.traced("eliminate", lambda: _check_removed(
        eliminate(g, rng.fold_in(key, reps + 1), t, o_v="random",
                  o_n="random"), want, reps + 1))
    log(f"one call traced: {traced['span_ms']:.1f} ms, the card busy "
        f"{traced['device_busy_ms']:.2f} ms of it")

    t0 = time.perf_counter()
    prices = RL.measure_prices(dev, n=n, e=e_live)
    prices_s = time.perf_counter() - t0
    log(f"prices (ns per element, at n={n} E={e_live}), {prices_s:.1f} s: "
        f"{prices['prices_ns']}; fixed parts (ms) {prices['fixed_ms']}")
    t0 = time.perf_counter()
    model_ms, model = RL.roofline_ms(g, FRAC, seed=0,
                                     prices=prices["prices_ns"])
    replay_s = time.perf_counter() - t0
    log(f"roofline (speed-of-light model), replayed in {replay_s:.1f} s: "
        f"{model_ms:.4f} ms, {model['rounds']} rounds, fraction "
        f"{model_ms / ms:.5f}; breakdown {model['breakdown_ms']}")
    return {"metric": "rlap_edges_per_s", "value": eps, "unit": "edges/s",
            "vs_baseline": eps / base_eps, "oracle_edges_per_s": base_eps,
            "ms_per_call": ms, "call_ms": [1e3 * s for s in call_s],
            "rounds": rounds, "removed": removed[-1], "oracle_s": oracle_s,
            "n": n, "m": M, "t": t, "directed_edges": e_live,
            "traced_call_ms": traced["span_ms"],
            "traced_call_device_busy_ms": traced["device_busy_ms"],
            "traced_call_kernels": traced["kernels"],
            "roofline_ms": model_ms, "roofline_fraction": model_ms / ms,
            "roofline_rounds": model["rounds"],
            "roofline_breakdown_ms": model["breakdown_ms"],
            "roofline_entry_exit_ms": model["entry_exit_ms"],
            "roofline_by_price_ms": model["by_price_ms"],
            "roofline_elements": model["elements"],
            "prices_ns": prices["prices_ns"],
            "price_fixed_ms": prices["fixed_ms"],
            "price_checks": {k: prices[k] for k in ("n", "e", "reps",
                                                    "launches",
                                                    "max_abs_err")},
            "prices_s": prices_s, "replay_s": replay_s,
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
