"""Seeds for the benchmark's inputs, derived from `--seed` by splitmix64,
so that one seed gives the same graph, features, weights and trainer key
in every run, and the parts never share a stream."""

from __future__ import annotations

import torch

MASK64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


PARTS = {"graph": 1, "features": 2, "weights": 3, "trainer": 4, "sample": 5}


def derive(seed: int, part: str) -> int:
    """A 63-bit seed for one part of a run's inputs."""
    return splitmix64(splitmix64(int(seed) & MASK64) ^ PARTS[part]) >> 1


def generator(seed: int, part: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, part))
    return gen
