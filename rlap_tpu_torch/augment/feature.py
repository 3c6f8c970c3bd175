"""Feature-space augmentors (counterpart of `rlap_tpu/augment/feature.py`)."""

from __future__ import annotations

import torch

from rlap_tpu_torch.augment.base import Augmentor
from rlap_tpu_torch.core.graph import Graph


def mask_feature_dims(x: torch.Tensor, key: torch.Generator,
                      pf: float) -> torch.Tensor:
    """Zero whole feature dimensions with probability pf: one column mask
    for all nodes."""
    keep = torch.rand(x.shape[-1], generator=key, device=x.device) >= pf
    return x * keep.to(x.dtype)[None, :]


def dropout_features(x: torch.Tensor, key: torch.Generator,
                     pf: float) -> torch.Tensor:
    """Per-element Bernoulli zeroing."""
    keep = torch.rand(x.shape, generator=key, device=x.device) >= pf
    return x * keep.to(x.dtype)


class FeatureMasking(Augmentor):
    def __init__(self, pf: float):
        self.pf = pf

    def augment(self, g: Graph, key: torch.Generator) -> Graph:
        if g.x is None:
            return g
        return g.replace(x=mask_feature_dims(g.x, key, self.pf))


class FeatureDropout(Augmentor):
    def __init__(self, pf: float):
        self.pf = pf

    def augment(self, g: Graph, key: torch.Generator) -> Graph:
        if g.x is None:
            return g
        return g.replace(x=dropout_features(g.x, key, self.pf))
