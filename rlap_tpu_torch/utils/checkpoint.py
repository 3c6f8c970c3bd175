"""Checkpoint and resume on `torch.save` / `torch.load` (counterpart of
`rlap_tpu/utils/checkpoint.py`, which uses orbax).

A checkpoint directory holds one file per saved step, `ckpt_<step>.pt`: a
nest of dicts, lists, numbers and tensors. A file is written under a
temporary name and renamed, so a run killed while saving leaves the
earlier steps readable. Files are read with `weights_only=True`, which
unpickles tensors and plain containers and nothing else.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Optional

import torch

_FILE = re.compile(r"ckpt_(\d+)\.pt")


def _file(path, step: int) -> Path:
    return Path(path).absolute() / f"ckpt_{int(step)}.pt"


def save_checkpoint(path: str, state: Any, step: int = 0) -> str:
    """Write `state` as step `step` under the directory `path`. Returns
    the file's path."""
    target = _file(path, step)
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, target)
    return str(target)


def latest_step(path: str) -> Optional[int]:
    """The latest saved step under `path`, or None when there is none."""
    p = Path(path).absolute()
    if not p.is_dir():
        return None
    steps = [int(m[1]) for m in map(_FILE.fullmatch, os.listdir(p)) if m]
    return max(steps) if steps else None


def restore_checkpoint(path: str, step: Optional[int] = None,
                       map_location=None) -> Any:
    """The state saved as `step` (the latest when None), with its tensors
    on `map_location` (where they were saved when None)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    return torch.load(_file(path, step), map_location=map_location,
                      weights_only=True)
