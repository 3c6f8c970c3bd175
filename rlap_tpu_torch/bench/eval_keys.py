"""Spread of MVGRL's test accuracy over its evaluation keys:

    python -m rlap_tpu_torch.bench.eval_keys [--dataset CORA]
        [--augmentor PPRDiffusion] [--epochs 100] [--seeds 0 1 2 3 4]
        [--keys 8] [--device cpu]

MVGRL embeds a view pair drawn from a pinned key (`EVAL_SEED`), feature
masking included, so every run on one device probes the embeddings of
one feature mask, whatever the training seed; the card and the CPU draw
different masks from the same key. For each training seed this trains
MVGRL as `rlap_tpu_torch.cli.run` does (the CLI's defaults: hidden 128,
2 layers, lr 1e-3, weight decay 1e-5, fractions 0.2), then probes the
embeddings of the pinned key and of `--keys` other keys
(`EVAL_SEED + 1 ...`) on split 0, and prints one JSON line per seed and
one of the means. The device is the card unless `--device` says
otherwise.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.augment.registry import make_augmentor_pair
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.data.loaders import load_dataset
from rlap_tpu_torch.eval.linear_probe import lr_evaluate
from rlap_tpu_torch.eval.split import get_split
from rlap_tpu_torch.models.mvgrl import EVAL_SEED, MVGRLTrainer


def run(dataset: str, augmentor: str, epochs: int, seed: int, keys: int,
        device=None) -> dict:
    dev = resolve_device(device)
    g, y, _meta = load_dataset(dataset, device=dev)
    a1, a2 = make_augmentor_pair(augmentor, 0.2, 0.2,
                                 num_nodes=g.num_nodes, device=dev)
    tr = MVGRLTrainer(a1, a2, augmentor_name=augmentor, seed=seed,
                      device=dev)
    losses = tr.fit(g, max_epochs=epochs)
    split = get_split(g.num_nodes, 0.1, 0.8, seed=0)
    num_classes = int(np.max(np.asarray(y))) + 1
    acc = [lr_evaluate(tr.embed(g, key=rng.key(EVAL_SEED + i, device=dev)),
                       y, split, num_classes=num_classes)["accuracy"]
           for i in range(keys + 1)]
    return {"seed": seed, "final_loss": losses[-1], "pinned_key": acc[0],
            "other_keys": acc[1:],
            "other_keys_mean": float(np.mean(acc[1:]))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="CORA")
    ap.add_argument("--augmentor", default="PPRDiffusion")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--keys", type=int, default=8)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    rows = []
    for seed in args.seeds:
        rows.append(run(args.dataset, args.augmentor, args.epochs, seed,
                        args.keys, args.device))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({
        "device": str(resolve_device(args.device)), "dataset": args.dataset,
        "augmentor": args.augmentor, "epochs": args.epochs,
        "pinned_key_mean": float(np.mean([r["pinned_key"] for r in rows])),
        "other_keys_mean": float(np.mean([r["other_keys_mean"]
                                          for r in rows]))}), flush=True)


if __name__ == "__main__":
    main()
