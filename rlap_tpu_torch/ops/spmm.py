"""Sparse message passing over padded COO edge lists: SpMM, SDDMM and the
GCN normalisation. Counterpart of `rlap_tpu/ops/spmm.py`.

On the card `spmm` is one hand-written kernel (`rlap_tpu_torch/csrc/
spmm.cu`): a segment-sum over the edges sorted by receiver, each output
row summed in registers in edge order and written once; its backward is
the same kernel over the edges sorted by sender. It reads no padding slot
and uses no atomics, so its float sums are taken in a fixed order and the
same inputs give the same bits, call after call. A row wider than one
warp's tile of columns (the PPR series' S, at width n) is split over the
launch's column tiles, a warp each; each element is still summed in
edge order. `segment_order` builds
each order on the card, with no read-back to the host. `spmm_plain` is the
plain PyTorch version (gather, scale and `index_add_` into n+1 rows, then
drop the sentinel row), which the wrapper runs for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. Each launch adds one to
`launch_counts["spmm_fwd"]` or `launch_counts["spmm_bwd"]`.

With a `mesh`, the graph is this rank's shard (`rlap_tpu_torch.parallel`):
its slice of the edges, with the global `num_nodes`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.ops import _build
from rlap_tpu_torch.utils import tracing

_STEM = "spmm"
SOURCE = _build.source_path(_STEM)
KERNELS = ("spmm_fwd", "spmm_bwd")
_LAUNCHERS = {torch.float32: "spmm_csr_f32", torch.float64: "spmm_csr_f64"}
_TILES = {torch.float32: "spmm_csr_tiles_f32",
          torch.float64: "spmm_csr_tiles_f64"}

launch_counts = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


def library_path() -> Path:
    return _build.library_path(_STEM)


def build(extra_flags: Tuple[str, ...] = ()) -> Tuple[Path, str]:
    """Compile the kernel unless a library of this source exists.
    Returns (library path, compiler output)."""
    return _build.build(_STEM, extra_flags)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in _LAUNCHERS.values():
        getattr(lib, name).argtypes = [ptr] * 5 + [i32, i32, ptr]
        getattr(lib, name).restype = ctypes.c_int
    for name in _TILES.values():
        getattr(lib, name).argtypes = [ptr, ptr, i32]
        getattr(lib, name).restype = ctypes.c_int


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1, x.shape[1]))], 0)


def segment_order(keys: torch.Tensor, other: torch.Tensor,
                  n: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The edges sorted stably by `keys` (values in [0, n]), where they
    lie and with no read-back: (rowptr, perm, col). `perm` (int64[E]) is
    the sorting permutation; segment i holds the sorted slots [rowptr[i],
    rowptr[i + 1]) (rowptr int32[n + 2], so the padding edges, whose keys
    are n, fill segment n); `col` (int32[E]) is `other[perm]`, the
    endpoint each slot gathers."""
    if n >= 2**31 - 1 or keys.shape[0] >= 2**31:
        raise ValueError(f"segment_order: n={n}, E={keys.shape[0]} do not "
                         f"fit int32")
    sorted_keys, perm = torch.sort(keys.to(torch.int32), stable=True)
    bounds = torch.arange(n + 2, dtype=torch.int32, device=keys.device)
    rowptr = torch.searchsorted(sorted_keys, bounds, out_int32=True)
    return rowptr, perm, other[perm].to(torch.int32)


def segment_sum(x: torch.Tensor, rowptr: torch.Tensor, col: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """The kernel alone, over an order of `segment_order`: out[i] = sum
    over k in [rowptr[i], rowptr[i + 1]) of w[k] * x[col[k]], for x
    [n, F] and w in x's dtype, all contiguous on one card; a slot whose
    col is n adds nothing. Counts no launch."""
    out = torch.empty_like(x)
    _build.launch(_STEM, _declare, _LAUNCHERS[x.dtype],
                  (x, rowptr, col, w, out), x.shape[0], x.shape[1])
    return out


def column_tiles(x: torch.Tensor, out: torch.Tensor) -> int:
    """The column tiles of `segment_sum`'s launch from `x` into `out`
    (`csrc/spmm.cu`'s own count, its grid's y): 1 where each row's
    columns fit one warp's tile."""
    lib = _build.load(_STEM, _declare)
    return getattr(lib, _TILES[x.dtype])(x.data_ptr(), out.data_ptr(),
                                         x.shape[1])


def _segment_sum(name: str, x: torch.Tensor, keys: torch.Tensor,
                 other: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[i] = sum over the edges e with keys[e] == i of w[e] *
    x[other[e]], by the kernel; `name` is the launch it counts as. While
    a profiler records, counts `spmm.tiled`: 1 where the launch's grid
    has more than one column tile, else 0."""
    rowptr, perm, col = segment_order(keys, other, x.shape[0])
    out = segment_sum(x, rowptr, col, w[perm].to(x.dtype))
    launch_counts[name] += 1
    if tracing.recording():
        tracing.count("spmm.tiled", int(column_tiles(x, out) > 1))
    return out


class _SpMM(torch.autograd.Function):
    """The kernel forward (segments by receiver) and backward (dx: the
    output's gradient gathered by receiver into segments by sender;
    d(weights): per-edge dots in plain PyTorch, only when asked for).
    Keeps nothing of size E x F."""

    @staticmethod
    def forward(ctx, x, w, senders, receivers):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w,
                              senders, receivers)
        return _segment_sum("spmm_fwd", x, receivers, senders, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, w, senders, receivers = ctx.saved_tensors
        grad = grad.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _segment_sum("spmm_bwd", grad, senders, receivers, w)
        if ctx.needs_input_grad[1]:
            dw = (_pad_row(x)[senders] * _pad_row(grad)[receivers]).sum(-1)
            dw = dw.to(w.dtype)
        return dx, dw, None, None


def spmm_plain(g: Graph, x: torch.Tensor,
               edge_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`spmm`'s function in plain PyTorch: gather, scale and `index_add_`
    into n+1 rows, the padding edges (sender == num_nodes) reading and
    writing the dropped sentinel row."""
    w = g.weights if edge_weights is None else edge_weights
    msgs = _pad_row(x)[g.senders] * w[:, None].to(x.dtype)
    out = x.new_zeros((g.num_nodes + 1, x.shape[1]))
    return out.index_add(0, g.receivers, msgs)[:g.num_nodes]


def spmm(g: Graph, x: torch.Tensor,
         edge_weights: Optional[torch.Tensor] = None, mesh=None,
         axis: str = "data") -> torch.Tensor:
    """out[i] = sum over edges (j -> i) of w_e * x[j].  x: [N, F] -> [N, F].

    On the card: the kernel, for a contiguous float32 or float64 `x`, with
    gradients for `x` and the weights; another dtype, a non-contiguous `x`
    or tensors on two devices raise. On the CPU: `spmm_plain`. Padding
    edges contribute nothing, nor does an edge whose sender is the
    sentinel (on the CPU, given a finite weight). With `mesh`, `g` is this
    rank's shard and the sum runs over the edges of every rank of `axis`
    (`parallel.spmm_edge_partitioned`: each rank's partial through this
    function, then one all-reduce); `x` and the result are replicated.

    While a profiler records (`utils/tracing.py`), the single-rank path
    counts the slots the call takes in (`spmm.slots`: the edge capacity)
    and the padding slots its aggregation reads (`spmm.padding`): every
    one in `spmm_plain`, which gathers the sentinel row for each, and none
    in the kernel; and, on the card, the kernel's launches (forward and
    dx) whose grid has more than one column tile (`spmm.tiled`: rows
    wider than a warp's tile, such as the PPR series' at width n)."""
    if mesh is not None:
        from rlap_tpu_torch.parallel.spmm import spmm_edge_partitioned

        return spmm_edge_partitioned(g, x, mesh, axis=axis,
                                     edge_weights=edge_weights)
    w = g.weights if edge_weights is None else edge_weights
    cpu = _build.on_cpu(x, g.senders, g.receivers, w)
    if tracing.recording():
        tracing.count("spmm.slots", g.senders.shape[0])
        tracing.count("spmm.padding", (g.senders == g.num_nodes).sum()
                      if cpu else 0)
    if cpu:
        return spmm_plain(g, x, w)
    if x.dtype not in _LAUNCHERS or not x.is_contiguous() \
            or x.dim() != 2 or x.shape[0] != g.num_nodes:
        raise ValueError(
            f"spmm: needs a contiguous float32 or float64 [num_nodes, F] "
            f"tensor on the card, got {x.dtype} {tuple(x.shape)} "
            f"contiguous={x.is_contiguous()} for num_nodes={g.num_nodes}")
    return _SpMM.apply(x, w, g.senders, g.receivers)


def sddmm(g: Graph, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-edge dot products: out_e = <a[sender_e], b[receiver_e]>."""
    return (_pad_row(a)[g.senders] * _pad_row(b)[g.receivers]).sum(-1)


def gcn_norm(g: Graph, add_self_loops: bool = True, mesh=None,
             axis: str = "data") -> tuple:
    """Symmetric GCN normalisation w_e / sqrt(d_s d_r), the degree summed
    over senders. With `add_self_loops`, self-loops of weight 1 replace
    any present and count in the degree; without, the graph is taken as
    it is (CCA-SSG adds its loops to the views itself). (The JAX
    package's `improved` option has no caller.)

    With `mesh`, `g` is this rank's shard: each rank adds the loops of its
    own node block, and the degrees are the global ones, the ranks'
    partials all-reduced over `axis`.

    Returns (graph_with_loops, normalized_edge_weights).
    """
    if add_self_loops:
        g = G.remove_self_loops(g)
        if mesh is None:
            g = G.add_self_loops(g)
        else:
            from rlap_tpu_torch.parallel.mesh import node_block

            cap = g.edge_capacity
            lo, hi = node_block(g.num_nodes, mesh, axis)
            g = G.add_self_loops(g)
            keep = torch.cat([torch.arange(cap, device=g.device),
                              torch.arange(cap + lo, cap + hi,
                                           device=g.device)])
            g = g.replace(senders=g.senders[keep],
                          receivers=g.receivers[keep],
                          weights=g.weights[keep])
    deg = G.weighted_degrees(g)
    if mesh is not None:
        import torch.distributed as dist

        dist.all_reduce(deg, group=mesh.get_group(axis))
    dinv = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)),
                       torch.zeros_like(deg))
    dpad = torch.cat([dinv, dinv.new_zeros((1,))])
    return g, g.weights * dpad[g.senders] * dpad[g.receivers]
