"""Run a function in spawned ranks of one process group.

    results = launch(fn, world_size, args=(...), backend="gloo")

Each rank is a process started by `torch.multiprocessing` with the spawn
method; it joins the default process group through a `file://` store in
a temporary directory (no port to find, nothing outside the directory),
calls `fn(rank, world_size, *args)`, and saves what it returns, which
must be made of tensors, numbers, strings, lists and dicts (loaded with
`weights_only=True`). `fn` must be a module-level function; the children
import its module, so keep that module free of imports they do not need.

A hung collective must fail, not stall: the process group and the join
share one timeout, and at the end every child still alive is killed.
Under torchrun, call `mesh.init_distributed()` instead.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _child(rank: int, fn: Callable, world_size: int, args: Sequence,
           backend: str, tmp: str, timeout: float) -> None:
    torch.set_num_threads(1)
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, world_size, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world_size: int, args: Sequence = (),
           backend: str = "gloo", timeout: float = 600.0) -> List[Any]:
    """`fn(rank, world_size, *args)` in `world_size` spawned ranks over
    `backend` ("nccl" needs one card per rank; "gloo" takes CPU and CUDA
    tensors). Returns the ranks' results in rank order. Raises if a rank
    raises, or `TimeoutError` after `timeout` seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _child, args=(fn, world_size, tuple(args), backend, tmp,
                          timeout),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{world_size} ranks of {fn.__name__} still running "
                        f"after {timeout} s")
                if ctx.join(timeout=left):
                    break
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=True)
                for r in range(world_size)]
