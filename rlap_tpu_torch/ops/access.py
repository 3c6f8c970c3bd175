"""Gather and scatter-min access probes: hand-written CUDA kernels for
Hopper, their plain PyTorch versions, and the wrappers.

The JAX package has no module of this name: its eight Pallas probes live
inside `main()` of `tools/probe_access.py` (C1 `pallas_take` :139, C2
`pallas_tala` :180, C3 `pallas_scalar` :215, C4 `pallas_smin` :251) and of
`tools/probe_access2.py` (V1 `try_variant` with `k_v1` :53/:85, V2
`call_v2` :102, V3 `call_v3` :143, V4 `call_v4` :194). The kernels
(`rlap_tpu_torch/csrc/access.cu`) replace them; the source says what each
is on this card. `rlap_tpu_torch/bench/probe_access.py` is the entry point
that times them beside torch's own gathers and scatters.

Each probe has one design: of those tried, the one that was faster on
the card (PERF.md section 6). C3 (`take_scalar`) stages its table in the
shared memory of a thread-block cluster and walks it with one thread; C4
(`scatter_min`) merges equal indices in registers and across the warp
before its atomics and overlaps its fill. C2 (`take_two_level`) launches
persistent clusters, each of which holds the whole table in equal slices
of its blocks' shared memory (`table_plan`) and serves its share of the
indices from there. C1 (`take`) reads its table from L2: a design that
held the table in a cluster and routed each index to the block holding
its entry took twice its time on every input measured, and was removed.
V4 (`take_axis0_axis1`) reads its table from L2 too: served from a
cluster-resident table it was slower. V2 (`take_axis0`) reads column j
for lane j only, so each block holds a slab of whole columns and serves
their reads with no cluster (`slab_plan`). V1 (`take2d`) computes what
the tool's kernel `k_v1` computes (`take2d_plain`): one table row for
each row of 128 indices, read whole by a warp, its lanes selected inside
the warp.

All tensors are int32 and contiguous. A table is `[n]`, or `[R, 128]` where
the probe is two-level; indices are `[E]`, or `[M, 128]` tiles for the 2-D
kernels, and must lie in `[0, table size)`: the kernels do not check them.
Each wrapper runs its plain version for tensors on the CPU and launches its
kernel for CUDA tensors, or raises: there is no fallback on the card. Each
launch adds one to `launch_counts[name]`. Results are bit-equal to the
plain versions.

`take_scalar` takes at most `TILE` indices and a table that `CLUSTER_MAX`
blocks' shared memory holds (`scalar_plan`: 456,672 entries beside 8192
indices), both 16-byte aligned for the bulk copies. `take_two_level`
takes a table that `CLUSTER_MAX` blocks hold (`table_plan`: 464,768
entries), 16-byte aligned, and raises `ValueError` beyond it;
`take_axis0` one whose slabs of 4 columns fit a block (`slab_plan`:
1,859,584 entries), at any offset; the others take any size at any
offset. `take` and `take_two_level` take indices at any offset (the last
one's output shares it), `take_axis0` index tiles at any offset, the
other 2-D kernels 16-byte aligned tiles. `scatter_min` takes indices and
values that lie at the same offset from a 16-byte boundary (views at any
offset). The wrappers check this for CPU tensors too, so
that both devices take the same inputs.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from rlap_tpu_torch.ops import _build
from rlap_tpu_torch.ops._build import on_cpu as _on_cpu

_STEM = "access"
SOURCE = _build.source_path(_STEM)
LANES = 128
FILL = 2 ** 30  # the start value of the scatter-min table, as in the tool
TILE = 8192  # the most indices of one scalar walk, the tool's tile
# Hopper: the shared memory one block may use, and the portable cluster size
SMEM_BLOCK = 232_448
CLUSTER_MAX = 8
BARRIER_BYTES = 16  # the mbarrier's slot at the head of a block's stage
# the cluster size of C2 where the table allows it: the fastest of k = 2, 4,
# 8 at n=100000 on the card (PERF.md section 6)
CLUSTER_DEFAULT = 2
# V2's column slabs: the widths a block may own, and the default
SLAB_COLS = (32, 16, 8, 4)
SLAB_DEFAULT = 32
KERNELS = ("take", "take_two_level", "take_scalar", "scatter_min", "take2d",
           "take_axis0", "take_axis1", "take_axis0_axis1")

launch_counts = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


class ScalarPlan(NamedTuple):
    """How `take_scalar` lays an n-entry table over a cluster: block 0
    holds entries [0, head) and the index tile, block r >= 1 holds
    [head + (r - 1) slice, head + r slice), the last block what is left.
    `smem` is the dynamic shared memory of each block, in bytes."""
    blocks: int
    head: int
    slice: int
    smem: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def scalar_plan(n: int, e: int) -> ScalarPlan:
    """The fewest blocks whose shared memory holds n table entries, block 0
    holding as many as fit beside its e indices. Raises ValueError for
    more than `TILE` indices or a table that `CLUSTER_MAX` blocks cannot
    hold."""
    if n <= 0 or not 0 <= e <= TILE:
        raise ValueError(f"take_scalar: needs a table and at most {TILE} "
                         f"indices, got n={n}, E={e}")
    idx_bytes = _round_up(4 * e, 16)
    cap0 = (SMEM_BLOCK - BARRIER_BYTES - idx_bytes) // 16 * 4
    cap = (SMEM_BLOCK - BARRIER_BYTES) // 16 * 4
    if n <= cap0:
        return ScalarPlan(1, n, 0, BARRIER_BYTES + _round_up(4 * n, 16)
                          + idx_bytes)
    blocks = 1 + -(-(n - cap0) // cap)
    if blocks > CLUSTER_MAX:
        raise ValueError(
            f"take_scalar: a table of {n} entries needs {blocks} blocks of "
            f"{SMEM_BLOCK} bytes of shared memory; a cluster has at most "
            f"{CLUSTER_MAX}, which hold {cap0 + (CLUSTER_MAX - 1) * cap} "
            f"entries beside {e} indices")
    slice_ = _round_up(-(-(n - cap0) // (blocks - 1)), 4)
    return ScalarPlan(blocks, cap0, slice_,
                      BARRIER_BYTES + max(4 * cap0 + idx_bytes, 4 * slice_))


class TablePlan(NamedTuple):
    """How C2 lays a table of nt entries over a cluster of `blocks`
    blocks: block r holds entries [r slice, (r + 1) slice), the last what
    is left; `smem` is each block's dynamic shared memory in bytes."""
    blocks: int
    slice: int
    smem: int


def _table_smem(nt: int, blocks: int) -> Tuple[int, int]:
    slice_ = _round_up(-(-nt // blocks), 4)
    return slice_, BARRIER_BYTES + 4 * slice_


def table_fits(nt: int, blocks: int) -> bool:
    """Whether a cluster of `blocks` blocks holds nt entries."""
    return (1 <= blocks <= CLUSTER_MAX
            and _table_smem(nt, blocks)[1] <= SMEM_BLOCK)


def table_plan(nt: int, blocks: Optional[int] = None) -> TablePlan:
    """The cluster that holds an nt-entry table in equal slices (multiples
    of 4 entries): `blocks` if given, else `CLUSTER_DEFAULT`, or the
    fewest blocks that hold the table where that many do not. Raises
    ValueError where the given `blocks`, or `CLUSTER_MAX` blocks, cannot
    hold it."""
    if nt <= 0:
        raise ValueError(f"table_plan: needs a table, got nt={nt}")
    if blocks is None:
        blocks = next((k for k in range(CLUSTER_DEFAULT, CLUSTER_MAX + 1)
                       if table_fits(nt, k)), CLUSTER_MAX)
    if not table_fits(nt, blocks):
        cap = (SMEM_BLOCK - BARRIER_BYTES) // 16 * 4 * CLUSTER_MAX
        raise ValueError(
            f"a table of {nt} entries does not fit a cluster of {blocks} "
            f"blocks of {SMEM_BLOCK} bytes of shared memory each; a cluster "
            f"has 1 to {CLUSTER_MAX} blocks, which hold at most {cap} "
            f"entries")
    return TablePlan(blocks, *_table_smem(nt, blocks))


class SlabPlan(NamedTuple):
    """How V2 cuts an [R, 128] table: `groups` slabs of `cols` columns,
    each held whole by a block in `smem` bytes of shared memory."""
    cols: int
    groups: int
    smem: int


def slab_fits(nt: int, cols: int) -> bool:
    """Whether a block holds the R x `cols` slab of an nt-entry table."""
    return cols in SLAB_COLS and 4 * (nt // LANES) * cols <= SMEM_BLOCK


def slab_plan(nt: int, cols: Optional[int] = None) -> SlabPlan:
    """V2's column slabs for an nt-entry [R, 128] table: `cols` where
    given, else `SLAB_DEFAULT`, or the widest narrower one whose slab a
    block holds. Raises ValueError where the given width, or slabs of 4
    columns, do not fit."""
    if nt <= 0 or nt % LANES:
        raise ValueError(f"slab_plan: needs a [R, {LANES}] table, got "
                         f"nt={nt}")
    if cols is not None and cols not in SLAB_COLS:
        raise ValueError(f"slab_plan: a slab is one of {SLAB_COLS} columns "
                         f"wide, got {cols}")
    tries = (cols,) if cols is not None else tuple(
        c for c in SLAB_COLS if c <= SLAB_DEFAULT)
    for c in tries:
        if slab_fits(nt, c):
            return SlabPlan(c, LANES // c, 4 * (nt // LANES) * c)
    cap = SMEM_BLOCK // (4 * min(SLAB_COLS)) * LANES
    raise ValueError(
        f"take_axis0: a slab of {tries[-1]} columns of a {nt}-entry table "
        f"does not fit a block's {SMEM_BLOCK} bytes of shared memory; "
        f"slabs of {min(SLAB_COLS)} columns hold at most {cap} entries")


def vector_split(ptr: int, e: int) -> Tuple[int, int]:
    """(head, quads): the updates before the first 16-byte boundary of an
    int32 array at address `ptr`, and the whole quads of 4 after them, of
    E updates; the rest is the tail."""
    head = min((-ptr) % 16 // 4, e)
    return head, (e - head) // 4


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
    lib.access_take2d.argtypes = [ptr, ptr, ptr, ptr, i32, ptr]
    lib.access_take_axis0.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                      i32, ptr]
    lib.access_take_two_level.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                          i32, i32, i32, i32, ptr]
    lib.access_take_scalar.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                       i32, i32, i32, ptr]
    lib.access_scatter_min.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                                       i32, ptr]
    lib.access_sm_clock_khz.argtypes = [i32, ctypes.POINTER(i32)]
    lib.access_sm_clock_khz.restype = ctypes.c_int


def sm_clock_khz(device=None) -> int:
    """The card's rated SM clock in kHz (`cudaDevAttrClockRate`), which
    turns the cycle counts of `take_scalar` into time."""
    dev = torch.device("cuda" if device is None else device)
    khz = ctypes.c_int(0)
    err = _build.load(_STEM, _declare).access_sm_clock_khz(
        dev.index or 0, ctypes.byref(khz))
    if err != 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed, cudaError {err}")
    return khz.value


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


def _aligned16(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tuple(t.shape)} tensor at address "
                             f"{t.data_ptr():#x} is not 16-byte aligned, as "
                             f"the bulk copies need")


def _spans(name: str, cycles: Optional[torch.Tensor], cpu: bool,
           like: torch.Tensor, size: int = 3) -> Optional[int]:
    """The device pointer of an optional int64 `cycles` buffer of `size`,
    which the cluster and slab kernels fill on the card only; None without
    one."""
    if cycles is None:
        return None
    if cpu:
        raise ValueError(f"{name}: cycles are counted on the card only")
    if (cycles.dtype != torch.int64 or cycles.numel() < size
            or cycles.device != like.device or not cycles.is_contiguous()):
        raise ValueError(f"{name}: cycles must be a contiguous int64 "
                         f"tensor of {size} on {like.device}")
    return cycles.data_ptr()


def _empty_at_offset(like: torch.Tensor) -> torch.Tensor:
    """An empty int32 tensor of `like`'s size that lies at `like`'s offset
    from a 16-byte boundary, so that both take the same 16-byte quads."""
    store = torch.empty(like.numel() + 3, dtype=torch.int32,
                        device=like.device)
    off = (like.data_ptr() - store.data_ptr()) % 16 // 4
    return store[off:off + like.numel()]


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


def take2d_plain(tab2d, idx2) -> torch.Tensor:
    """out[i, j] = tab2d[idx2[i, 0] // 128, idx2[i, j] % 128], int32: what
    V1's kernel `k_v1` (`tools/probe_access2.py:85-92`) computes. It gathers
    the table row of every index, keeps `sel[:, 0, :]`, the row of each
    index row's first index, and selects the lanes `idx2 % 128` from it.
    (Its harness `try_variant`, which `main` never calls, checks it
    against the flat gather, `take_two_level_plain`, at :74-75.)"""
    rows, lanes = _rows_lanes(idx2)
    return torch.take_along_dim(tab2d[rows[:, 0]], lanes, 1)


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
    """C1: the lookup with the table served from L2; any size, table and
    indices at any offset."""
    _check("take", table, idx, two_level=False, tiles=False)
    if _on_cpu(table, idx):
        return take_plain(table, idx)
    out = torch.empty_like(idx)
    _launch("take", (table, idx, out), idx.numel())
    return out


def take_two_level(tab2d: torch.Tensor, idx: torch.Tensor,
                   blocks: Optional[int] = None,
                   cycles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C2: the lookup from a table held whole in the shared memory of each
    of a grid of clusters (`table_plan(nt, blocks)`); indices at any
    offset, any E. On the card, an int64 `cycles` of 3 entries receives
    cluster 0's staging and lookup spans in SM cycles and the number of
    clusters launched."""
    _check("take_two_level", tab2d, idx, two_level=True, tiles=False)
    cpu = _on_cpu(tab2d, idx)
    plan = table_plan(tab2d.numel(), blocks)
    _aligned16("take_two_level", tab2d)
    spans = _spans("take_two_level", cycles, cpu, tab2d)
    if cpu:
        return take_two_level_plain(tab2d, idx)
    out = _empty_at_offset(idx)
    e = idx.numel()
    _launch("take_two_level", (tab2d, idx, out), spans, tab2d.numel(), e,
            *vector_split(idx.data_ptr(), e), *plan)
    return out


def take_scalar(table: torch.Tensor, idx: torch.Tensor,
                cycles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C3: the lookup by one thread, one element after another, with the
    table in the shared memory of a cluster (`scalar_plan`). On the card,
    an int64 `cycles` of 3 entries receives the staging and walk spans in
    SM cycles and how many reads went to another block."""
    _check("take_scalar", table, idx, two_level=False, tiles=False)
    cpu = _on_cpu(table, idx)
    plan = scalar_plan(table.numel(), idx.numel())
    _aligned16("take_scalar", table, idx)
    spans = _spans("take_scalar", cycles, cpu, table)
    if cpu:
        return take_plain(table, idx)
    out = torch.empty_like(idx)
    _launch("take_scalar", (table, idx, out), spans, table.numel(),
            idx.numel(), *plan)
    return out


def scatter_min(idx: torch.Tensor, val: torch.Tensor,
                size: int) -> torch.Tensor:
    """C4: a `[size]` table of 2**30, min-reduced with `val` at `idx`;
    equal indices merged before the atomics. `idx` and `val` may be views
    at any offset, but at the same offset from a 16-byte boundary."""
    if idx.dim() != 1 or idx.shape != val.shape or size <= 0:
        raise ValueError(f"scatter_min: indices {tuple(idx.shape)} and "
                         f"values {tuple(val.shape)} must be equal [E], "
                         f"size {size} > 0")
    if size >= 2 ** 31:
        raise ValueError(f"scatter_min: a table of {size} entries does not "
                         f"fit int32")
    cpu = _on_cpu(idx, val)
    if idx.data_ptr() % 16 != val.data_ptr() % 16:
        raise ValueError(f"scatter_min: indices at {idx.data_ptr():#x} and "
                         f"values at {val.data_ptr():#x} lie at different "
                         f"offsets from a 16-byte boundary")
    if cpu:
        return scatter_min_plain(idx, val, size)
    out = torch.empty((size,), dtype=torch.int32, device=idx.device)
    _launch("scatter_min", (idx, val, out), size, idx.numel(),
            *vector_split(idx.data_ptr(), idx.numel()), FILL)
    return out


def _tiles(name: str, plain, tab2d, idx2,
           cycles: Optional[torch.Tensor] = None,
           spans: bool = False) -> torch.Tensor:
    """The 2-D kernels that take 16-byte aligned index tiles and any M;
    with `spans`, the kernel takes an optional int64 `cycles` of 3."""
    _check(name, tab2d, idx2, two_level=True, tiles=True)
    cpu = _on_cpu(tab2d, idx2)
    extra = (_spans(name, cycles, cpu, tab2d),) if spans else ()
    if cpu:
        return plain(tab2d, idx2)
    out = torch.empty_like(idx2)
    if idx2.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"{name}: index tiles must be 16-byte aligned")
    _launch(name, (tab2d, idx2, out), *extra, idx2.shape[0])
    return out


def take2d(tab2d: torch.Tensor, idx2: torch.Tensor,
           cycles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """V1: out[i, j] = tab2d[idx2[i, 0] // 128, idx2[i, j] % 128]
    (`take2d_plain`, the tool's `k_v1`) on [M, 128] index tiles, one warp
    reading each index row's table row whole and selecting its lanes; any
    M. On the card, an int64 `cycles` of 3 entries receives warp 0 of
    block 0's load and select spans in SM cycles and the blocks
    launched."""
    return _tiles("take2d", take2d_plain, tab2d, idx2, cycles, spans=True)


def take_axis0(tab2d: torch.Tensor, idx2: torch.Tensor,
               cols: Optional[int] = None,
               cycles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """V2: out[i, j] = tab2d[idx2[i, j] // 128, j], each block serving the
    reads of one group of columns from a slab of them in its shared memory
    (`slab_plan(nt, cols)`); table and tiles at any offset, any M. On the
    card, an int64 `cycles` of 3 entries receives block 0's staging and
    lookup spans in SM cycles and the blocks launched."""
    name = "take_axis0"
    _check(name, tab2d, idx2, two_level=True, tiles=True)
    cpu = _on_cpu(tab2d, idx2)
    plan = slab_plan(tab2d.numel(), cols)
    spans = _spans(name, cycles, cpu, tab2d)
    if cpu:
        return take_axis0_plain(tab2d, idx2)
    out = torch.empty_like(idx2)
    _launch(name, (tab2d, idx2, out), spans, tab2d.numel(), idx2.shape[0],
            *plan)
    return out


def take_axis1(tab2d: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
    """V3: out[i, j] = tab2d[0, idx2[i, j] % 128]."""
    return _tiles("take_axis1", take_axis1_plain, tab2d, idx2)


def take_axis0_axis1(tab2d: torch.Tensor,
                     idx2: torch.Tensor) -> torch.Tensor:
    """V4: V2, then V3's lane select on its result
    (`take_axis0_axis1_plain`), one warp an index row staging its row of
    V2's result in shared memory; the table read from L2, any size."""
    return _tiles("take_axis0_axis1", take_axis0_axis1_plain, tab2d, idx2)

