"""A GRACE + rLap training epoch at production scale, with separate and
with paired views.

    python -m rlap_tpu_torch.bench.epoch [n] [frac] [epochs]
        [--device D] [--out PATH]

Counterpart of `tools/bench_epoch.py`. One epoch is two rLap views,
feature masking, the shared 2-layer GCN encoder and projection head,
dual-branch InfoNCE (on the card, the fused kernels) and an Adam update,
on BA(n, m=8, seed 0), n = 100000 by default, with 128-d Gaussian
features from `np.random.default_rng(0)` and
`GraceTrainer(hidden_dim=128, num_layers=2, seed=0)`. Two variants:

* separate: `Compose([RLap(frac), FeatureMasking(0.3)])` for each view,
  two `eliminate` calls an epoch (the recipe's default);
* paired: `PairedRLap(frac, pf=0.3)`, one `eliminate_pair` call.

Each epoch is timed between two synchronisations of the card, the first
(model set-up) apart from the others; then the augmentation alone, for
each variant; and one view of the sequential C++ oracle on the host
(median of 3), for the reference's floor of two such views an epoch.
Every view must remove exactly int(frac n) nodes; the InfoNCE kernel
launches of each variant are counted.

Diagnostics go to stderr; stdout gets one JSON line with the keys of
`tools/bench_epoch.py`'s record and `first_epoch_ms_*`, the epochs one by
one, the launches, `device` and, on the card, its name and power limit.
A file is written only with `--out`. Without `--device cpu` it runs on the
card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.augment.base import Compose
from rlap_tpu_torch.augment.feature import FeatureMasking
from rlap_tpu_torch.augment.rlap import PairedRLap, RLap
from rlap_tpu_torch.bench import describe, log, sync
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.data.synthetic import barabasi_albert
from rlap_tpu_torch.models.grace import GraceTrainer
from rlap_tpu_torch.native import live_edges, oracle_approximate_cholesky
from rlap_tpu_torch.ops import infonce_fused as K

HIDDEN, LAYERS, FEATURES, PF = 128, 2, 128, 0.3


def _isolated(g) -> torch.Tensor:
    """Nodes without an edge, as a device scalar (no host sync)."""
    return (G.degrees(g) == 0).sum()


def _counting_views(tr: GraceTrainer, counts: list) -> None:
    """Make `tr` append each view's count of nodes without an edge to
    `counts`, read after the timing."""
    views = tr.views

    def counted(g):
        v1, v2 = views(g)
        counts.extend((_isolated(v1), _isolated(v2)))
        return v1, v2

    tr.views = counted


def run(n: int = 100_000, frac: float = 0.2, epochs: int = 3, device=None,
        out: Optional[str] = None) -> dict:
    """Measure both variants on `device` (the card by default) and return
    the record that `main` prints; write it to `out` when given."""
    dev = resolve_device(device)
    g = barabasi_albert(n, 8, seed=0, device=dev)
    x = np.random.default_rng(0).normal(size=(n, FEATURES)).astype("float32")
    g = g.replace(x=torch.as_tensor(x, device=dev))
    e_live = int(g.num_edges)
    num_remove = int(frac * n)
    base_isolated = int(_isolated(g))
    log(f"device {dev}: BA(n={n}, m=8): {e_live} directed edges; "
        f"frac={frac}")
    res = {"n": n, "frac": frac, "directed_edges": e_live,
           "hidden_dim": HIDDEN, "num_layers": LAYERS}
    isolated: list = []

    def time_epochs(tr: GraceTrainer, label: str) -> None:
        _counting_views(tr, isolated)
        before = dict(K.launch_counts)
        each = []
        for _ in range(epochs + 1):
            sync(dev)
            t0 = time.perf_counter()
            tr.train_epoch(g)
            sync(dev)
            each.append(1e3 * (time.perf_counter() - t0))
        res[f"first_epoch_ms_{label}"] = each[0]
        res[f"epoch_ms_{label}"] = float(np.mean(each[1:]))
        res[f"epochs_ms_{label}"] = each[1:]
        res[f"infonce_launches_{label}"] = {
            k: K.launch_counts[k] - before[k] for k in K.launch_counts}
        log(f"{label}: first epoch {each[0]:.1f} ms, then {each[1:]} ms")

    def time_views(make_views, label: str) -> None:
        key = rng.key(1, device=dev)
        each = []
        for i in range(epochs):
            sync(dev)
            t0 = time.perf_counter()
            views = make_views(rng.fold_in(key, i))
            sync(dev)
            each.append(1e3 * (time.perf_counter() - t0))
            isolated.extend(_isolated(v) for v in views)
        res[f"augmentation_ms_{label}"] = float(np.mean(each))
        log(f"{label} augmentation alone: {each} ms")

    a1, a2 = (Compose([RLap(frac, device=dev), FeatureMasking(PF)])
              for _ in range(2))
    time_epochs(GraceTrainer(a1, a2, hidden_dim=HIDDEN, num_layers=LAYERS,
                             seed=0, device=dev), "separate")

    def separate(k):
        k1, k2 = rng.split(k)
        return a1(g, k1), a2(g, k2)

    time_views(separate, "separate")
    pair = PairedRLap(frac, pf=PF, device=dev)
    time_epochs(GraceTrainer(hidden_dim=HIDDEN, num_layers=LAYERS, seed=0,
                             pair_augmentor=pair, device=dev), "paired")
    time_views(lambda k: pair(g, k), "paired")

    removed = sorted({int(c) - base_isolated for c in isolated})
    if removed != [num_remove]:
        raise AssertionError(f"views removed {removed} nodes, not "
                             f"{num_remove}")

    ei, _w = live_edges(g)
    oracle_ms = []
    for i in range(3):
        t0 = time.perf_counter()
        oracle_approximate_cholesky(ei, None, n, num_remove, o_v="random",
                                    o_n="random", seed=i)
        oracle_ms.append(1e3 * (time.perf_counter() - t0))
    oracle = float(np.median(oracle_ms))
    log(f"host oracle, one view: {oracle_ms} ms")

    res.update(
        encoder_loss_ms=res["epoch_ms_separate"]
        - res["augmentation_ms_separate"],
        cpu_oracle_view_ms=oracle,
        reference_augmentation_floor_ms=2 * oracle,
        epochs_timed=epochs, views_checked=len(isolated),
        removed_per_view=num_remove, **describe(dev))
    if out is not None:
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    return res


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=100_000)
    ap.add_argument("frac", type=float, nargs="?", default=0.2)
    ap.add_argument("epochs", type=int, nargs="?", default=3)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the host; the card by default")
    ap.add_argument("--out", default=None, help="also write the record here")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, args.frac, args.epochs, args.device,
                         args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
