"""Key plumbing on `torch.Generator`: counterparts of `jax.random.split`
and `jax.random.fold_in`.

A key is a `torch.Generator` used as a seed. Deriving a child reads only
the parent's `initial_seed()`, never its stream position, so a child is a
pure function of (parent seed, index): drawing from a key does not change
the keys derived from it, as with JAX keys. The child lives on the
parent's device and is seeded with a splitmix64 hash of the parent seed,
the index and a domain tag, so `split(k, m)[i]` and `fold_in(k, i)` are
different keys, as in JAX.

The streams are Philox (CUDA) or Mersenne Twister (CPU), not threefry: the
same seed gives other numbers than the JAX package. Tests that compare the
two packages feed both the same numpy inputs.
"""

from __future__ import annotations

from typing import List

import torch

from rlap_tpu_torch import resolve_device

_MASK64 = (1 << 64) - 1
_FOLD, _SPLIT = 0x5EED_F01D, 0x5EED_5B17


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def key(seed: int, device=None) -> torch.Generator:
    """A root key on `device`: the card when None, as for every other
    entry point, so that a key and a graph made with the same `device=`
    (or with none) live together."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed) & _MASK64)
    return gen


def _child(parent: torch.Generator, data: int, tag: int) -> torch.Generator:
    seed = _splitmix64(_splitmix64(parent.initial_seed() ^ tag)
                       ^ (int(data) & _MASK64))
    return key(seed, device=parent.device)


def fold_in(parent: torch.Generator, data: int) -> torch.Generator:
    """The child key of `parent` for the integer `data`."""
    return _child(parent, data, _FOLD)


def split(parent: torch.Generator, num: int = 2) -> List[torch.Generator]:
    """`num` independent child keys of `parent`."""
    return [_child(parent, i, _SPLIT) for i in range(num)]
