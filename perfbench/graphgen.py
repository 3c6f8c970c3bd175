"""The benchmark's inputs, made on the device from the seed. The
configuration's `graph` group names its `kind`, and `graphs/<kind>.py`
defines `make(spec, seed, device)`, found by that name as recipes and
metrics are. What `make` returns (one `Graph` of the program, or a
dataset of many) is handed as it is to the trainer and to the recipe's
check."""

from __future__ import annotations

from pathlib import Path

GRAPHS = Path(__file__).resolve().parent / "graphs"


def make_graph(spec: dict, seed: int, device):
    """The inputs of the configuration's `graph` group."""
    from perfbench.harness import load_file

    path = GRAPHS / f"{spec['kind']}.py"
    if not path.is_file():
        raise ValueError(f"unknown graph kind {spec['kind']!r}: no {path}")
    return load_file(path).make(spec, seed, device)
