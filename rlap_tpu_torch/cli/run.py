"""Experiment runner CLI: one grid point per invocation, or a sweep
(counterpart of `rlap_tpu/cli/run.py`, with the same flags plus
`--device`, the same JSONL events and fields, and the same sweep grids).

Usage:
  python -m rlap_tpu_torch.cli.run --recipe grace --dataset CORA \\
      --augmentor rLap --fraction1 0.2 --fraction2 0.2 [--results-dir out/]
  python -m rlap_tpu_torch.cli.run --sweep --recipe grace --results-dir out/
  python -m rlap_tpu_torch.cli.run --recipe grace --dataset CORA \\
      --device cpu --max-epochs 3

Everything runs on `--device`, the card unless told otherwise; without a
card and without `--device cpu` the run raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.augment.cca_registry import CCA_AUGMENTORS
from rlap_tpu_torch.utils.config import ExperimentConfig, sweep


def _log_test_runs(log, tr, data, y, eval_repeats: int) -> None:
    for rep in range(eval_repeats):
        res = tr.evaluate(data, y, seed=rep)
        log.log("test_run", repeat=rep, micro_f1=res["micro_f1"],
                macro_f1=res["macro_f1"], accuracy=res["accuracy"])


def run_one(cfg: ExperimentConfig, results_dir=None, eval_repeats: int = 1,
            checkpoint_dir=None, checkpoint_every: int = 100, device=None):
    """Train and evaluate one configuration on `device` (the card by
    default), logging JSONL events (config, dataset, final_loss, epochs,
    raw_feature_baseline, test_run, wall_seconds) to
    `<results_dir>/<run_name>.jsonl`. Returns the logger."""
    from rlap_tpu_torch.augment.registry import make_augmentor_pair
    from rlap_tpu_torch.data.loaders import load_dataset, load_graph_dataset
    from rlap_tpu_torch.utils.logging import MetricsLogger

    dev = resolve_device(device)
    log = MetricsLogger(
        path=None if results_dir is None
        else f"{results_dir}/{cfg.run_name()}.jsonl",
        run_id=cfg.run_name(), recipe=cfg.recipe, dataset=cfg.dataset,
        augmentor=cfg.augmentor)
    log.log("config", **dataclasses.asdict(cfg))
    t0 = time.time()
    common = dict(hidden_dim=cfg.hidden_dim, num_layers=cfg.num_layers,
                  lr=cfg.lr, weight_decay=cfg.weight_decay, seed=cfg.seed,
                  device=dev)
    ckpt = dict(checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every)

    if cfg.recipe in ("grace", "mvgrl", "cca_ssg"):
        g, y, meta = load_dataset(cfg.dataset, device=dev)
        log.log("dataset", num_nodes=g.num_nodes, num_edges=int(g.num_edges),
                synthetic=meta["synthetic"])

        if cfg.recipe == "grace":
            from rlap_tpu_torch.models.grace import GraceTrainer

            a1, a2 = make_augmentor_pair(cfg.augmentor, cfg.fraction1,
                                         cfg.fraction2,
                                         num_nodes=g.num_nodes, device=dev)
            tr = GraceTrainer(a1, a2, **common)
            losses = tr.fit(g, max_epochs=cfg.max_epochs,
                            tolerance=cfg.tolerance, **ckpt)
        elif cfg.recipe == "mvgrl":
            from rlap_tpu_torch.models.mvgrl import MVGRLTrainer

            a1, a2 = make_augmentor_pair(cfg.augmentor, cfg.fraction1,
                                         cfg.fraction2,
                                         num_nodes=g.num_nodes, device=dev)
            tr = MVGRLTrainer(a1, a2, augmentor_name=cfg.augmentor, **common)
            losses = tr.fit(g, max_epochs=cfg.max_epochs,
                            tolerance=cfg.tolerance, **ckpt)
        else:
            from rlap_tpu_torch.augment.cca_registry import make_cca_augmentor
            from rlap_tpu_torch.models.cca_ssg import CCASSGTrainer

            aug = make_cca_augmentor(
                cfg.augmentor if cfg.augmentor in CCA_AUGMENTORS else "rlap",
                cfg.feat_drop_rate, cfg.fraction1)
            tr = CCASSGTrainer(aug, out_dim=cfg.hidden_dim, lam=cfg.lam,
                               **common)
            losses = tr.fit(g, max_epochs=min(cfg.max_epochs, 100), **ckpt)

        # a run resumed from a finished checkpoint trains no epoch
        losses = losses or [float("nan")]
        log.metric("final_loss", losses[-1], step=len(losses))
        log.metric("epochs", len(losses))
        # the same probe on the raw features: embeddings must beat it
        from rlap_tpu_torch.eval.linear_probe import lr_evaluate
        from rlap_tpu_torch.eval.split import get_split

        raw = lr_evaluate(g.x, y, get_split(g.num_nodes, 0.1, 0.8, seed=0),
                          num_classes=int(np.max(np.asarray(y))) + 1)
        log.log("raw_feature_baseline", accuracy=raw["accuracy"],
                micro_f1=raw["micro_f1"])
        _log_test_runs(log, tr, g, y, eval_repeats)
    else:
        graphs, y, meta = load_graph_dataset(cfg.dataset, device=dev)
        log.log("dataset", num_graphs=len(graphs),
                synthetic=meta["synthetic"])
        a1, a2 = make_augmentor_pair(cfg.augmentor, cfg.fraction1,
                                     cfg.fraction2,
                                     num_nodes=max(g.num_nodes
                                                   for g in graphs),
                                     device=dev)
        if cfg.recipe == "graphcl":
            from rlap_tpu_torch.models.graphcl import GraphCLTrainer

            tr = GraphCLTrainer(a1, a2, **common)
        else:
            from rlap_tpu_torch.models.bgrl import BGRLTrainer

            tr = BGRLTrainer(a1, a2, **common)
        losses = tr.fit(graphs, max_epochs=min(cfg.max_epochs, 100),
                        tolerance=cfg.tolerance, **ckpt)
        losses = losses or [float("nan")]
        log.metric("final_loss", losses[-1], step=len(losses))
        _log_test_runs(log, tr, graphs, y, eval_repeats)

    log.metric("wall_seconds", time.time() - t0)
    return log


# the reference's grids per recipe
FRACS = [0.1, 0.2, 0.3, 0.4, 0.5]
GRIDS = {
    "node": dict(
        augmentor=["rLap", "rLapRandomDesc", "rLapRandomRandom",
                   "rLapDegree", "rLapCoarsen", "EdgeAddition",
                   "EdgeDropping", "NodeDropping", "PPRDiffusion",
                   "MarkovDiffusion"],
        num_layers=[2, 4, 8], lr=[1e-2, 1e-3, 1e-4],
        hidden_dim=[128, 256, 512], fraction1=FRACS, fraction2=FRACS),
    "graph": dict(
        dataset=["PROTEINS_full", "MUTAG", "IMDB-BINARY", "IMDB-MULTI",
                 "NCI1"],
        augmentor=["rLap", "EdgeAddition", "EdgeDropping", "NodeDropping",
                   "PPRDiffusion"],
        fraction1=FRACS, fraction2=FRACS),
    "cca_ssg": dict(
        dataset=["CORA", "CITESEER", "AMAZON-COMPUTERS"],
        augmentor=list(CCA_AUGMENTORS), fraction1=FRACS),
}


def sweep_grid(recipe: str) -> dict:
    if recipe in ("grace", "mvgrl"):
        return GRIDS["node"]
    if recipe in ("graphcl", "bgrl"):
        return GRIDS["graph"]
    return GRIDS["cca_ssg"]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for f in dataclasses.fields(ExperimentConfig):
        p.add_argument(f"--{f.name.replace('_', '-')}", type=type(f.default),
                       default=f.default)
    p.add_argument("--results-dir", type=str, default=None)
    p.add_argument("--eval-repeats", type=int, default=1)
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="save trainer state here every --checkpoint-every "
                        "epochs and resume from it on restart (all recipes)")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--sweep", action="store_true",
                   help="run the reference grid for --recipe")
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on (default: the card, cuda)")
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    cfg = ExperimentConfig(**{f.name: getattr(args, f.name)
                              for f in dataclasses.fields(ExperimentConfig)})
    if not args.sweep:
        run_one(cfg, results_dir=args.results_dir,
                eval_repeats=args.eval_repeats,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every, device=args.device)
        return
    for point in sweep(cfg, results_dir=args.results_dir,
                       **sweep_grid(cfg.recipe)):
        print(f"=== {point.run_name()} ===", file=sys.stderr, flush=True)
        run_one(point, results_dir=args.results_dir,
                eval_repeats=args.eval_repeats, device=args.device)


if __name__ == "__main__":
    main()
