"""Glue that the recipes share: weights made on the device by the
program's initialisation laws, loaded into the program's model by name."""

from __future__ import annotations

import math
from typing import Dict

import torch

# flax's lecun_normal: a normal truncated at two standard deviations has
# std 0.87962566103423978; dividing by it gives variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def glorot_uniform(out_dim: int, in_dim: int, gen, device) -> torch.Tensor:
    a = math.sqrt(6.0 / (in_dim + out_dim))
    return (torch.rand(out_dim, in_dim, generator=gen, device=device)
            * 2 - 1) * a


def lecun_normal(out_dim: int, in_dim: int, gen, device) -> torch.Tensor:
    w = torch.empty(out_dim, in_dim, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w * (math.sqrt(1.0 / in_dim) / _TRUNC_STD)


def load_weights(model: torch.nn.Module,
                 weights: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's weights into the program's parameters, which
    must be exactly these names and shapes."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the program's parameters {sorted(params)} are not "
                         f"the benchmark's {sorted(weights)}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(weights[k].reshape(p.shape))
