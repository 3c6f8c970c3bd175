"""CCA-SSG's feature-decorrelation objective (counterpart of
`rlap_tpu/objectives/cca.py`): embeddings standardised per dimension,
then
  loss = -tr(z1^T z2) + lam (||I - z1^T z1||_F^2 + ||I - z2^T z2||_F^2),
the 1/N of the covariances folded into the standardisation.
"""

from __future__ import annotations

from typing import Optional

import torch


def standardize(z: torch.Tensor, node_mask: Optional[torch.Tensor] = None,
                eps: float = 1e-8) -> torch.Tensor:
    """(z - mean) / (std sqrt(N)) per dimension, over the real nodes when
    `node_mask` is given (padding rows are zeroed first)."""
    if node_mask is None:
        n = z.shape[0]
        mean = z.mean(0)
        var = z.var(0, unbiased=False)
    else:
        m = node_mask.to(z.dtype)[:, None]
        n = m.sum().clamp_min(1.0)
        mean = (z * m).sum(0) / n
        var = (((z - mean) ** 2) * m).sum(0) / n
        z = z * m
    return (z - mean) * torch.rsqrt(var * n + eps)


def cca_ssg_loss(z1: torch.Tensor, z2: torch.Tensor, lam: float = 1e-3,
                 node_mask: Optional[torch.Tensor] = None,
                 pre_standardized: bool = False) -> torch.Tensor:
    if not pre_standardized:
        z1 = standardize(z1, node_mask)
        z2 = standardize(z2, node_mask)
    elif node_mask is not None:
        m = node_mask.to(z1.dtype)[:, None]
        z1, z2 = z1 * m, z2 * m
    eye = torch.eye(z1.shape[1], dtype=z1.dtype, device=z1.device)
    inv = -torch.trace(z1.T @ z2)
    dec = ((eye - z1.T @ z1) ** 2).sum() + ((eye - z2.T @ z2) ** 2).sum()
    return inv + lam * dec
