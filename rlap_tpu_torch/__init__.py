"""rlap_tpu_torch: the PyTorch/CUDA port of `rlap_tpu`, for one NVIDIA H100.

The module layout mirrors `rlap_tpu` path for path, so the counterpart of
`rlap_tpu/ops/spmm.py` is `rlap_tpu_torch/ops/spmm.py`. The package imports
torch and numpy only; it shares no code with the JAX package.

Entry points (`GraceTrainer`, `approximate_cholesky`, `RLap`, the synthetic
generators, `rng.key`) run on `default_device()` unless the caller passes
`device=`. `Graph` and `approximate_cholesky` are re-exported here, as the
JAX package does. There is no silent CPU fallback: without a card, torch
raises at the first CUDA allocation.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The device entry points use when the caller names none: the card.
    Availability is not checked here; torch raises at first use."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    return default_device() if device is None else torch.device(device)


# below `resolve_device`, which these modules import from the package
from rlap_tpu_torch.core.graph import Graph  # noqa: E402,F401
from rlap_tpu_torch.ops.rlap import approximate_cholesky  # noqa: E402,F401
