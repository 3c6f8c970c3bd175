"""CCA-SSG's functional augmentors (counterpart of
`rlap_tpu/augment/cca_registry.py`).

Ten functions `(g, key, feat_drop_rate, frac) -> Graph`, where g.x holds
the features; both views of a step come from the same function. Each runs
its topology augmentor with the first of two child keys and masks
feature columns with the second. The rLap view is computed on the graph's
device.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from rlap_tpu_torch.augment.adaptive import (EdgeDroppingDegree,
                                             EdgeDroppingEVC, EdgeDroppingPR)
from rlap_tpu_torch.augment.diffusion import MarkovDiffusion, PPRDiffusion
from rlap_tpu_torch.augment.edge import EdgeAdding, EdgeRemoving, NodeDropping
from rlap_tpu_torch.augment.feature import mask_feature_dims
from rlap_tpu_torch.augment.rlap import RLap
from rlap_tpu_torch.augment.rw import RWSampling
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.core.rng import split

# single-entry diffusion caches, as in the JAX package: (graph, view). The
# strong reference to the graph keeps an `is` check from matching a new
# graph that reuses a collected one's id.
_MARKOVD_CACHE: list = [None, None]
_PPRD_CACHE: list = [None, None]


def _with_feat_drop(topology_fn):
    def fn(g: Graph, key: torch.Generator, feat_drop_rate: float,
           frac: float) -> Graph:
        k1, k2 = split(key)
        out = topology_fn(g, k1, frac)
        if out.x is not None:
            out = out.replace(x=mask_feature_dims(out.x, k2, feat_drop_rate))
        return out

    fn.__name__ = topology_fn.__name__
    fn.__doc__ = topology_fn.__doc__
    return fn


def _cached(cache: list, g: Graph, make):
    if cache[0] is not g:
        cache[0], cache[1] = g, make()
    return cache[1]


@_with_feat_drop
def random_aug(g, key, frac):
    """Each undirected pair dropped with probability `frac`."""
    return EdgeRemoving(pe=frac)(g, key)


@_with_feat_drop
def rlap_aug(g, key, frac):
    return RLap(frac=frac, o_v="random", o_n="asc", device=g.device)(g, key)


@_with_feat_drop
def ea_aug(g, key, frac):
    return EdgeAdding(pe=frac)(g, key)


@_with_feat_drop
def nd_aug(g, key, frac):
    """`frac` is the keep probability, as CCA-SSG passes it."""
    return NodeDropping(pn=1.0 - frac)(g, key)


@_with_feat_drop
def markovd_aug(g, key, frac):
    return _cached(_MARKOVD_CACHE, g,
                   lambda: MarkovDiffusion(alpha=0.05)(g, key))


@_with_feat_drop
def pprd_aug(g, key, frac):
    return _cached(_PPRD_CACHE, g, lambda: PPRDiffusion(alpha=0.2)(g, key))


@_with_feat_drop
def rws_aug(g, key, frac):
    return RWSampling(num_seeds=max(int(frac * g.num_nodes), 1),
                      walk_length=10)(g, key)


@_with_feat_drop
def ed_deg_aug(g, key, frac):
    return EdgeDroppingDegree(p=frac, threshold=0.7)(g, key)


@_with_feat_drop
def ed_ppr_aug(g, key, frac):
    return EdgeDroppingPR(p=frac, threshold=0.7)(g, key)


@_with_feat_drop
def ed_evc_aug(g, key, frac):
    return EdgeDroppingEVC(p=frac, threshold=0.7)(g, key)


CCA_AUGMENTORS: Dict[str, Callable] = {
    "random": random_aug,
    "rlap": rlap_aug,
    "ea": ea_aug,
    "nd": nd_aug,
    "markovd": markovd_aug,
    "pprd": pprd_aug,
    "rws": rws_aug,
    "ed_deg": ed_deg_aug,
    "ed_ppr": ed_ppr_aug,
    "ed_evc": ed_evc_aug,
}


def make_cca_augmentor(name: str, feat_drop_rate: float, frac: float):
    """Bind a name to `(g, key) -> Graph`, the augmentor of
    `CCASSGTrainer`."""
    fn = CCA_AUGMENTORS[name]

    def aug(g: Graph, key: torch.Generator) -> Graph:
        return fn(g, key, feat_drop_rate, frac)

    return aug
