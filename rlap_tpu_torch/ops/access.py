"""Gather and scatter-min access probes: eight hand-written CUDA kernels
for Hopper, their plain PyTorch versions, and the wrappers.

The JAX package has no module of this name: its eight Pallas probes live
inside `main()` of `tools/probe_access.py` (C1 `pallas_take` :139, C2
`pallas_tala` :180, C3 `pallas_scalar` :215, C4 `pallas_smin` :251) and of
`tools/probe_access2.py` (V1 `try_variant` with `k_v1` :53/:85, V2
`call_v2` :102, V3 `call_v3` :143, V4 `call_v4` :194). The kernels
(`rlap_tpu_torch/csrc/access.cu`) replace them; the source says what each
is on this card. `rlap_tpu_torch/bench/probe_access.py` is the entry point
that times them beside torch's own gathers and scatters.

All tensors are int32 and contiguous. A table is `[n]`, or `[R, 128]` where
the probe is two-level; indices are `[E]`, or `[M, 128]` tiles for the 2-D
kernels, and must lie in `[0, table size)`: the kernels do not check them.
Each wrapper runs its plain version for tensors on the CPU and launches its
kernel for CUDA tensors, or raises: there is no fallback on the card. Each
launch adds one to `launch_counts[name]`. Results are bit-equal to the
plain versions.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from rlap_tpu_torch.ops import _build
from rlap_tpu_torch.ops._build import on_cpu as _on_cpu

_STEM = "access"
SOURCE = _build.source_path(_STEM)
LANES = 128
FILL = 2 ** 30  # the start value of the scatter-min table, as in the tool
KERNELS = ("take", "take_two_level", "take_scalar", "scatter_min", "take2d",
           "take_axis0", "take_axis1", "take_axis0_axis1")

launch_counts = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def library_path() -> Path:
    return _build.library_path(_STEM)


def build(extra_flags: Tuple[str, ...] = ()) -> Tuple[Path, str]:
    """Compile the kernels unless a library of this source exists.
    Returns (library path, compiler output)."""
    return _build.build(_STEM, extra_flags)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in KERNELS:
        fn = getattr(lib, f"access_{name}")
        fn.argtypes = [ptr, ptr, ptr, i32, ptr]
        fn.restype = ctypes.c_int
    lib.access_take_two_level.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
    lib.access_scatter_min.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]


def _launch(name: str, tensors, *sizes: int) -> None:
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous int32 tensors, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name}: {t.numel()} elements do not fit int32")
    _build.launch(_STEM, _declare, f"access_{name}", tensors, *sizes)
    launch_counts[name] += 1


def _check(name: str, table: torch.Tensor, idx: torch.Tensor,
           two_level: bool, tiles: bool) -> None:
    want_t = (2, f"[R, {LANES}]") if two_level else (1, "[n]")
    want_i = (2, f"[M, {LANES}]") if tiles else (1, "[E]")
    for what, t, (dim, text) in (("table", table, want_t),
                                 ("indices", idx, want_i)):
        if t.dim() != dim or (dim == 2 and t.shape[1] != LANES):
            raise ValueError(f"{name}: {what} must be {text}, got "
                             f"{tuple(t.shape)}")
    if table.numel() == 0:
        raise ValueError(f"{name}: empty table")


def _rows_lanes(idx: torch.Tensor):
    return ((idx // LANES).to(torch.int64), (idx % LANES).to(torch.int64))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def take_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[e] = table[idx[e]]."""
    return table[idx.to(torch.int64)]


def take_two_level_plain(tab2d, idx) -> torch.Tensor:
    """out[e] = tab2d[idx[e] // 128, idx[e] % 128]."""
    rows, lanes = _rows_lanes(idx)
    return tab2d[rows, lanes]


def scatter_min_plain(idx, val, size: int) -> torch.Tensor:
    """out = full(size, 2**30); out[idx[e]] = min(out[idx[e]], val[e])."""
    out = torch.full((size,), FILL, dtype=torch.int32, device=idx.device)
    return out.scatter_reduce_(0, idx.to(torch.int64), val, "amin")


def take_axis0_plain(tab2d, idx2) -> torch.Tensor:
    """out[i, j] = tab2d[idx2[i, j] // 128, j]."""
    return torch.take_along_dim(tab2d, _rows_lanes(idx2)[0], 0)


def take_axis1_plain(tab2d, idx2) -> torch.Tensor:
    """out[i, j] = tab2d[0, idx2[i, j] % 128]."""
    return torch.take_along_dim(tab2d[0:1].expand(idx2.shape[0], LANES),
                                _rows_lanes(idx2)[1], 1)


def take_axis0_axis1_plain(tab2d, idx2) -> torch.Tensor:
    """byrow[i, k] = tab2d[idx2[i, k] // 128, k], then
    out[i, j] = byrow[i, idx2[i, j] % 128]. Not the full lookup: the tool
    times these two gathers and says so."""
    rows, lanes = _rows_lanes(idx2)
    return torch.take_along_dim(torch.take_along_dim(tab2d, rows, 0),
                                lanes, 1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """C1: the lookup with the table served from L2; any E."""
    _check("take", table, idx, two_level=False, tiles=False)
    if _on_cpu(table, idx):
        return take_plain(table, idx)
    out = torch.empty_like(idx)
    _launch("take", (table, idx, out), idx.numel())
    return out


def take_two_level(tab2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """C2: the lookup with the table staged through shared memory in
    chunks."""
    _check("take_two_level", tab2d, idx, two_level=True, tiles=False)
    if _on_cpu(tab2d, idx):
        return take_two_level_plain(tab2d, idx)
    out = torch.empty_like(idx)
    _launch("take_two_level", (tab2d, idx, out), tab2d.numel(), idx.numel())
    return out


def take_scalar(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """C3: the lookup by one thread, one element after another."""
    _check("take_scalar", table, idx, two_level=False, tiles=False)
    if _on_cpu(table, idx):
        return take_plain(table, idx)
    out = torch.empty_like(idx)
    _launch("take_scalar", (table, idx, out), idx.numel())
    return out


def scatter_min(idx: torch.Tensor, val: torch.Tensor,
                size: int) -> torch.Tensor:
    """C4: a `[size]` table of 2**30, min-reduced with `val` at `idx`."""
    if idx.dim() != 1 or idx.shape != val.shape or size <= 0:
        raise ValueError(f"scatter_min: indices {tuple(idx.shape)} and values "
                         f"{tuple(val.shape)} must be equal [E], size "
                         f"{size} > 0")
    if _on_cpu(idx, val):
        return scatter_min_plain(idx, val, size)
    out = torch.empty((size,), dtype=torch.int32, device=idx.device)
    _launch("scatter_min", (idx, val, out), size, idx.numel(), FILL)
    return out


def _tiles(name: str, plain, tab2d, idx2) -> torch.Tensor:
    _check(name, tab2d, idx2, two_level=True, tiles=True)
    if _on_cpu(tab2d, idx2):
        return plain(tab2d, idx2)
    out = torch.empty_like(idx2)
    if idx2.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"{name}: index tiles must be 16-byte aligned")
    _launch(name, (tab2d, idx2, out), idx2.shape[0])
    return out


def take2d(tab2d: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
    """V1: the full lookup on [M, 128] index tiles; any M."""
    return _tiles("take2d", take_two_level_plain, tab2d, idx2)


def take_axis0(tab2d: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
    """V2: out[i, j] = tab2d[idx2[i, j] // 128, j]."""
    return _tiles("take_axis0", take_axis0_plain, tab2d, idx2)


def take_axis1(tab2d: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
    """V3: out[i, j] = tab2d[0, idx2[i, j] % 128]."""
    return _tiles("take_axis1", take_axis1_plain, tab2d, idx2)


def take_axis0_axis1(tab2d: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
    """V4: V2, then V3's lane select on its result."""
    return _tiles("take_axis0_axis1", take_axis0_axis1_plain, tab2d, idx2)

