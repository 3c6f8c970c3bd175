"""Augmentors: (Graph, key) -> Graph."""

from rlap_tpu_torch.augment.base import (Augmentor, Compose,  # noqa: F401
                                         Identity, RandomChoice)
from rlap_tpu_torch.augment.feature import (FeatureDropout,  # noqa: F401
                                            FeatureMasking)
from rlap_tpu_torch.augment.edge import (EdgeAdding,  # noqa: F401
                                         EdgeRemoving, NodeDropping)
from rlap_tpu_torch.augment.rlap import RLap  # noqa: F401
from rlap_tpu_torch.augment.adaptive import (  # noqa: F401
    EdgeDroppingDegree, EdgeDroppingPR, EdgeDroppingEVC,
    degree_drop_weights, pr_drop_weights, evc_drop_weights,
    compute_pagerank, eigenvector_centrality)
from rlap_tpu_torch.augment.diffusion import (  # noqa: F401
    PPRDiffusion, MarkovDiffusion, PPRDiffusionSubGraph, RLapPPRDiffusion,
    compute_ppr_dense, ppr_diffusion_graph)
from rlap_tpu_torch.augment.rw import RWSampling  # noqa: F401
from rlap_tpu_torch.augment.registry import (  # noqa: F401
    AUGMENTOR_NAMES, make_augmentor_pair)
