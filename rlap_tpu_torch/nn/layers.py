"""Small building-block layers (counterpart of `rlap_tpu/nn/layers.py`).

Parameter names follow flax (`dense_0`, `scale`, `bias`, and the batch
statistics `mean` and `var`), so `rlap_tpu_torch/convert.py` carries the
JAX package's parameters over by name.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn


# flax's lecun_normal: truncated_normal(-2, 2) has std 0.8796; dividing by
# it gives variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    std = (1.0 / w.shape[1]) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return w.mul_(std)


def _dense(fan_in: int, fan_out: int,
           generator: Optional[torch.Generator]) -> nn.Linear:
    lin = nn.Linear(fan_in, fan_out)
    lecun_normal_(lin.weight, generator)
    nn.init.zeros_(lin.bias)
    return lin


class PReLU(nn.Module):
    """Parametric ReLU with one learnable scalar slope, initialised to 0.25
    (`where(x >= 0, x, slope * x)`, the JAX package's form)."""

    def __init__(self, init_slope: float = 0.25):
        super().__init__()
        self.slope = nn.Parameter(torch.tensor(float(init_slope)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.slope * x)


class MLP(nn.Module):
    """Dense -> act -> ... -> Dense over `features`, from `in_dim` (flax
    infers it; torch needs it). Dense layers are lecun-normal with zero
    bias, as flax's `nn.Dense`."""

    def __init__(self, in_dim: int, features: Sequence[int],
                 activation: Callable = nn.functional.relu,
                 activate_final: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.activate_final = activate_final
        self.num_layers = len(features)
        dims = [in_dim] + list(features)
        for i in range(self.num_layers):
            self.add_module(f"dense_{i}",
                            _dense(dims[i], dims[i + 1], generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.num_layers - 1 or self.activate_final:
                x = self.activation(x)
        return x


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the node axis that ignores padding rows: with a
    `mask`, the mean and the (biased) variance are taken over real nodes
    only. The running statistics follow flax's convention,
    `ra = momentum * ra + (1 - momentum) * batch`, and are updated in
    place on every call that does not use them."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                use_running_average: bool = False) -> torch.Tensor:
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            if mask is None:
                mean = x.mean(0)
                var = x.var(0, unbiased=False)
            else:
                m = mask.to(x.dtype)[:, None]
                cnt = m.sum().clamp_min(1.0)
                mean = (x * m).sum(0) / cnt
                var = (((x - mean) ** 2) * m).sum(0) / cnt
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(
                    (1 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.scale + self.bias


def global_add_pool(x: torch.Tensor, segment_ids: torch.Tensor,
                    num_graphs: int) -> torch.Tensor:
    """Sum-pool node features per graph: [N, F] -> [num_graphs, F].
    Padding nodes carry segment id == num_graphs and are dropped."""
    out = torch.zeros((num_graphs + 1, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    return out.index_add(0, segment_ids.to(torch.int64), x)[:-1]


def global_mean_pool(x: torch.Tensor, segment_ids: torch.Tensor,
                     num_graphs: int) -> torch.Tensor:
    s = global_add_pool(x, segment_ids, num_graphs)
    cnt = global_add_pool(torch.ones((x.shape[0], 1), dtype=x.dtype,
                                     device=x.device), segment_ids,
                          num_graphs)
    return s / cnt.clamp_min(1.0)
