"""Augmentor protocol: (Graph, key) -> Graph, with explicit generator keys.
Counterpart of `rlap_tpu/augment/base.py`. Eager PyTorch has no traced
variant, so the JAX package's `traceable` methods have no counterpart."""

from __future__ import annotations

from typing import Sequence

import torch

from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.core.rng import fold_in
from rlap_tpu_torch.utils import tracing


class Augmentor:
    """Base: subclasses implement `augment(g, key) -> Graph`."""

    def augment(self, g: Graph, key: torch.Generator) -> Graph:
        raise NotImplementedError

    def __call__(self, g: Graph, key: torch.Generator) -> Graph:
        return self.augment(g, key)


class Identity(Augmentor):
    def augment(self, g: Graph, key: torch.Generator) -> Graph:
        return g


class Compose(Augmentor):
    """Stage i gets `fold_in(key, i)`."""

    def __init__(self, augmentors: Sequence[Augmentor]):
        self.augmentors = list(augmentors)

    def augment(self, g: Graph, key: torch.Generator) -> Graph:
        for i, aug in enumerate(self.augmentors):
            g = aug(g, fold_in(key, i))
        return g


class RandomChoice(Augmentor):
    """Apply `num_choices` of the augmentors, drawn without replacement
    per call from `fold_in(key, 0xC401CE)`; the j-th chosen one gets
    `fold_in(key, j + 1)`. The selection is read on the host."""

    def __init__(self, augmentors: Sequence[Augmentor], num_choices: int = 1):
        self.augmentors = list(augmentors)
        self.num_choices = num_choices

    def augment(self, g: Graph, key: torch.Generator) -> Graph:
        sel_key = fold_in(key, 0xC401CE)
        idx = torch.randperm(len(self.augmentors), generator=sel_key,
                             device=sel_key.device)[:self.num_choices]
        for j, i in enumerate(idx.tolist()):
            g = self.augmentors[i](g, fold_in(key, j + 1))
        return g


class CachedAugmentor(Augmentor):
    """Wrap an augmentor so that its output is reused for `refresh_every`
    calls before it is computed again. While a profiler records, each
    reuse counts one `diffusion.cache_hits` (the diffusion views are what
    the registry caches)."""

    def __init__(self, inner: Augmentor, refresh_every: int = 50):
        self.inner = inner
        self.refresh_every = refresh_every
        self._cache = None
        self._count = 0

    def augment(self, g: Graph, key: torch.Generator) -> Graph:
        if self._cache is not None and self._count < self.refresh_every:
            self._count += 1
            tracing.count("diffusion.cache_hits", 1)
            return self._cache
        self._cache = self.inner(g, key)
        self._count = 1
        return self._cache
