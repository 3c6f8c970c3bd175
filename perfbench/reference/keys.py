"""The key derivation the program documents for its augmentors
(`rlap_tpu_torch/core/rng.py`: a child key's seed is a splitmix64 hash of
the parent seed, a domain tag and the index), frozen here, so that the
reference draws what a view of a given key draws."""

from __future__ import annotations

from typing import List

import torch

_MASK64 = (1 << 64) - 1
_FOLD, _SPLIT = 0x5EED_F01D, 0x5EED_5B17


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _child(seed: int, data: int, tag: int) -> int:
    return _splitmix64(_splitmix64(seed ^ tag) ^ (int(data) & _MASK64))


def fold_in(seed: int, data: int) -> int:
    return _child(seed, data, _FOLD)


def split(seed: int, num: int = 2) -> List[int]:
    return [_child(seed, i, _SPLIT) for i in range(num)]


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & _MASK64)
    return gen
