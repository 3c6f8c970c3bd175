"""Measurement entry points of the port (counterpart of `rlap_tpu/bench`)."""

from __future__ import annotations

import subprocess
import sys

import torch


def log(*a) -> None:
    """Diagnostics of the entry points go to stderr; stdout keeps their
    one JSON line."""
    print(*a, file=sys.stderr, flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def describe(dev: torch.device) -> dict:
    """The device a result was measured on: the card's name, and its name
    and power limit as `nvidia-smi` prints them; "cpu" on the host."""
    if dev.type != "cuda":
        return {"device": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, timeout=60, check=True)
    return {"device": torch.cuda.get_device_name(dev),
            "card": smi.stdout.strip()}
