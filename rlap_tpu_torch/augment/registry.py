"""Augmentor registry: the 16 named (view 1, view 2) pipelines of the GRACE
recipe plus MVGRL's `rLapPPRDiffusion`, each topology augmentor composed
with FeatureMasking(pf) (counterpart of `rlap_tpu/augment/registry.py`).
The rLap views are computed on `device` (the card by default); the other
augmentors work where the graph is.
"""

from __future__ import annotations

from typing import Tuple

from rlap_tpu_torch.augment.adaptive import (EdgeDroppingDegree,
                                             EdgeDroppingEVC, EdgeDroppingPR)
from rlap_tpu_torch.augment.base import (Augmentor, CachedAugmentor, Compose,
                                         Identity)
from rlap_tpu_torch.augment.diffusion import (MarkovDiffusion, PPRDiffusion,
                                              RLapPPRDiffusion)
from rlap_tpu_torch.augment.edge import EdgeAdding, EdgeRemoving, NodeDropping
from rlap_tpu_torch.augment.feature import FeatureMasking
from rlap_tpu_torch.augment.rlap import RLap
from rlap_tpu_torch.augment.rw import RWSampling

AUGMENTOR_NAMES = (
    "rLap", "rLapRandomDesc", "rLapRandomRandom",
    "rLapDegree", "rLapDegreeDesc", "rLapDegreeRandom", "rLapCoarsen",
    "EdgeAddition", "EdgeDropping",
    "EdgeDroppingDegree", "EdgeDroppingPR", "EdgeDroppingEVC",
    "NodeDropping", "RandomWalkSubgraph",
    "PPRDiffusion", "MarkovDiffusion",
)

RLAP_VARIANTS = {  # name -> (o_v, o_n)
    "rLap": ("random", "asc"),
    "rLapRandomDesc": ("random", "desc"),
    "rLapRandomRandom": ("random", "random"),
    "rLapDegree": ("degree", "asc"),
    "rLapDegreeDesc": ("degree", "desc"),
    "rLapDegreeRandom": ("degree", "random"),
    "rLapCoarsen": ("coarsen", "asc"),
}


def make_augmentor_pair(name: str, fraction1: float, fraction2: float,
                        num_nodes: int = 0, pf: float = 0.3,
                        use_cache: bool = True,
                        device=None) -> Tuple[Augmentor, Augmentor]:
    """The (view 1, view 2) pipelines of a registry name. The diffusion
    views are cached: PPR and Markov for the whole run, rLap + PPR for 50
    calls."""

    def pair(a1, a2):
        return (Compose([a1, FeatureMasking(pf=pf)]),
                Compose([a2, FeatureMasking(pf=pf)]))

    def cached(d, refresh_every):
        return CachedAugmentor(d, refresh_every) if use_cache else d

    if name in RLAP_VARIANTS:
        o_v, o_n = RLAP_VARIANTS[name]
        return pair(RLap(fraction1, o_v=o_v, o_n=o_n, device=device),
                    RLap(fraction2, o_v=o_v, o_n=o_n, device=device))
    if name == "EdgeAddition":
        return pair(EdgeAdding(pe=fraction1), EdgeAdding(pe=fraction2))
    if name == "EdgeDropping":
        return pair(EdgeRemoving(pe=fraction1), EdgeRemoving(pe=fraction2))
    adaptive = {"EdgeDroppingDegree": EdgeDroppingDegree,
                "EdgeDroppingPR": EdgeDroppingPR,
                "EdgeDroppingEVC": EdgeDroppingEVC}
    if name in adaptive:
        cls = adaptive[name]
        return pair(cls(p=fraction1, threshold=0.7),
                    cls(p=fraction2, threshold=0.7))
    if name == "NodeDropping":
        return pair(NodeDropping(pn=fraction1), NodeDropping(pn=fraction2))
    if name == "RandomWalkSubgraph":
        return pair(RWSampling(num_seeds=max(int(fraction1 * num_nodes), 1)),
                    RWSampling(num_seeds=max(int(fraction2 * num_nodes), 1)))
    if name == "PPRDiffusion":
        return pair(Identity(), cached(PPRDiffusion(alpha=0.2), 1 << 30))
    if name == "MarkovDiffusion":
        return pair(Identity(), cached(MarkovDiffusion(alpha=0.05), 1 << 30))
    if name == "rLapPPRDiffusion":
        # MVGRL's own pairing
        return pair(Identity(),
                    cached(RLapPPRDiffusion(frac=fraction2, device=device),
                           50))
    raise ValueError(f"unknown augmentor {name!r}; "
                     f"choose from {AUGMENTOR_NAMES + ('rLapPPRDiffusion',)}")
