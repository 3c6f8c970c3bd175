"""Shared trainer plumbing (counterpart of `rlap_tpu/models/common.py`)."""

from __future__ import annotations

import inspect
from typing import Iterable, Optional

import torch

from rlap_tpu_torch.core import rng
from rlap_tpu_torch.utils.checkpoint import (latest_step, restore_checkpoint,
                                             save_checkpoint)


def torch_adam(params: Iterable[torch.nn.Parameter], lr: float,
               weight_decay: float = 0.0) -> torch.optim.Adam:
    """L2 decay added to the gradient before the moment updates: the same
    update as the JAX package's `chain(add_decayed_weights(wd), adam(lr))`."""
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)


class EarlyStopper:
    """Stop when the train loss has not improved for `tolerance` epochs."""

    def __init__(self, tolerance: int = 50):
        self.tolerance = tolerance
        self.best = float("inf")
        self.count = 0

    def update(self, loss: float) -> bool:
        if loss < self.best:
            self.best = loss
            self.count = 0
        else:
            self.count += 1
        return self.count >= self.tolerance


def init_generator(trainer) -> torch.Generator:
    """A CPU generator for a new model's weights, seeded from a key split
    off the trainer's, so that the weights do not depend on the device."""
    trainer.key, k = rng.split(trainer.key)
    return rng.key(k.initial_seed(), device="cpu")


def make_union_batches(graphs, batch_size: int, shuffle_seed: int = 0,
                       device=None, feature_dim: Optional[int] = None):
    """Shuffle the graphs and pad them into block-diagonal unions of one
    fixed capacity, (batch, segment_ids, number of graphs) each, on
    `device` (the card by default). An augmentor sees one disjoint-union
    graph per batch. The capacities do not depend on the shuffle (the sum
    of the `batch_size` largest graphs, rounded up to 128 nodes and 256
    edges), as in the JAX package, so that batches compare one to one.
    Featureless graphs get x = ones of width `feature_dim`."""
    import numpy as np

    from rlap_tpu_torch.core import graph as G

    def cap(sizes, mult):
        worst = sum(sorted(sizes, reverse=True)[:batch_size])
        return max(mult, (worst + mult - 1) // mult * mult)

    ncap = cap([g.num_nodes for g in graphs], 128)
    ecap = cap([int(g.num_edges) for g in graphs], 256)
    idx = np.random.default_rng(shuffle_seed).permutation(len(graphs))
    batches = []
    for start in range(0, len(idx), batch_size):
        chunk = [graphs[int(i)] for i in idx[start:start + batch_size]]
        batch, seg = G.block_diagonal(chunk, node_capacity=ncap,
                                      edge_capacity=ecap,
                                      feature_dim=feature_dim, device=device)
        batches.append((batch, seg, len(chunk)))
    return batches


def checkpointed_fit(trainer, g, max_epochs: int, tolerance: int,
                     verbose: bool = False,
                     checkpoint_dir: Optional[str] = None,
                     checkpoint_every: int = 100,
                     log_every: int = 50) -> list:
    """Call `trainer.train_epoch(g)` until early stopping or `max_epochs`,
    and return the losses of the epochs run by this call. A trainer whose
    `train_epoch` takes `epoch` (to shuffle its batches per epoch) is
    passed the epoch's index.

    With `checkpoint_dir`, the state is saved every `checkpoint_every`
    epochs, at the stop and at the last epoch, and a call that finds a
    checkpoint resumes after its epoch. The checkpoint holds the model's
    parameters and buffers, the optimizer's state, the trainer's key
    (seed and generator state), the trainer's attributes named in its
    `_ckpt_extra` (state outside the optimised model, such as BGRL's
    target parameters), and the early-stop state with the flag that the
    stop has fired, so a resumed run never trains past a recorded stop: a
    killed run restarts where it left off and gives the losses of the
    uninterrupted run. Trainer protocol: `train_epoch(g)`,
    `ensure_init(g)`, and the attributes `model`, `optimizer`, `key` and
    `device`."""
    stopper = EarlyStopper(tolerance)
    extra = tuple(getattr(trainer, "_ckpt_extra", ()))
    wants_epoch = "epoch" in inspect.signature(
        trainer.train_epoch).parameters

    def state(epoch: int, stopped: bool) -> dict:
        st = dict(model=trainer.model.state_dict(),
                  optimizer=trainer.optimizer.state_dict(),
                  key_seed=trainer.key.initial_seed(),
                  key_state=trainer.key.get_state(),
                  epoch=epoch, best=stopper.best, count=stopper.count,
                  stopped=stopped)
        for name in extra:
            st[name] = getattr(trainer, name)
        return st

    start_epoch = 0
    if checkpoint_dir is not None and latest_step(checkpoint_dir) is not None:
        trainer.ensure_init(g)
        st = restore_checkpoint(checkpoint_dir, map_location=trainer.device)
        trainer.model.load_state_dict(st["model"])
        trainer.optimizer.load_state_dict(st["optimizer"])
        trainer.key = rng.key(st["key_seed"], device=trainer.device)
        trainer.key.set_state(st["key_state"].cpu())
        for name in extra:
            setattr(trainer, name, st[name])
        stopper.best, stopper.count = st["best"], st["count"]
        start_epoch = max_epochs if st["stopped"] else st["epoch"] + 1

    losses = []
    for epoch in range(start_epoch, max_epochs):
        loss = (trainer.train_epoch(g, epoch=epoch) if wants_epoch
                else trainer.train_epoch(g))
        losses.append(loss)
        if verbose and epoch % log_every == 0:
            print(f"epoch {epoch}: loss {loss:.4f}")
        stop = stopper.update(loss)
        if checkpoint_dir is not None and (
                stop or epoch == max_epochs - 1
                or (epoch + 1) % checkpoint_every == 0):
            save_checkpoint(checkpoint_dir, state(epoch, stop), step=epoch)
        if stop:
            break
    return losses
