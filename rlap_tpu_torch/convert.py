"""Carry the JAX package's parameters into the port's modules.

The parameters arrive as a nested dict of numpy arrays, as flax's
`GRACE.init(...)["params"]` gives them, for example
`encoder/conv_0/{lin/kernel, bias}`, `encoder/act_0/slope`,
`project/fc1/{kernel, bias}`. flax stores a dense kernel as [in, out] and
`nn.Linear` its weight as [out, in], so kernels are transposed. The
port's encoders keep their layers in `convs`, `acts` and `bns` lists, so
`conv_i`, `act_i` and `bn_i` become `convs.i`, `acts.i` and `bns.i`.
Every other name is kept: `MLP`'s `dense_i`, flax's automatic names
(`Dense_0`, `MaskedBatchNorm_0`, `PReLU_0`), which the port's modules
take as attribute names, and leaf parameters such as CCA-SSG's `prelu_i`
and the slopes of `ChannelPReLU`. `MaskedBatchNorm`'s `scale` and `bias`
keep their names; its running statistics live in flax's separate
`batch_stats` collection (`mean`, `var`) and become the module's buffers
of the same names. The same function carries BGRL's target parameters,
which have the structure of its online ones.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_LAYER = re.compile(r"(conv|act|bn)_(\d+)")


def _name(key: str) -> str:
    m = _LAYER.fullmatch(key)
    return f"{m[1]}s.{m[2]}" if m else key


def flax_to_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None
                       ) -> Dict[str, torch.Tensor]:
    """A `state_dict` for the port's module of the same structure, from
    flax's `params` and, where the module has batch norms, `batch_stats`."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: str):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{_name(k)}.")
            elif k == "kernel":
                out[f"{prefix}weight"] = torch.from_numpy(
                    np.array(v, dtype=np.float32).T.copy())
            else:
                out[f"{prefix}{k}"] = torch.from_numpy(
                    np.array(v, dtype=np.float32))

    walk(params, "")
    if batch_stats is not None:
        walk(batch_stats, "")
    return out


def load_flax_params(module: nn.Module, params: Mapping,
                     batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Copy flax parameters (and batch statistics) into `module` in place
    (strict: every parameter and buffer on both sides must match). Returns
    the module."""
    state = flax_to_state_dict(params, batch_stats)
    module.load_state_dict(state, strict=True)
    return module
