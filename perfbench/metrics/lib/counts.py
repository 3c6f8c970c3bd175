"""The operations and bytes of the work a step needs, computed from
shapes: the yardstick of `step_mfu` and of the `*_roofline` metrics.

Each function returns `Op`s. FLOPs count a multiply-add as two and each
FLOP once, whatever precision the hardware uses. Bytes count each input
byte read once and each output byte written once, at the widths the
program holds (float32 values, int64 indices), whatever a kernel reads
again. Where the work depends on the data (a sparse product), the count is
of the edges these inputs hold.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List

F32 = 4
I64 = 8


@dataclass(frozen=True)
class Op:
    name: str
    flops: float
    bytes: float


def least_seconds(ops: Iterable[Op], peak: dict) -> float:
    """The least time the chip could take: per operation the larger of
    its FLOPs over the peak rate and its bytes over the peak bandwidth,
    summed."""
    return sum(max(o.flops / peak["flops_f32"], o.bytes / peak["bytes_per_s"])
               for o in ops)


def total_flops(ops: Iterable[Op]) -> float:
    return sum(o.flops for o in ops)


def matmul(m: int, k: int, n: int, name: str = "matmul") -> Op:
    """[m, k] x [k, n]."""
    return Op(name, 2.0 * m * k * n, F32 * (m * k + k * n + m * n))


def linear_bwd(m: int, k: int, n: int, input_grad: bool = True) -> List[Op]:
    """The backward of [m, k] x [k, n]: the weight's gradient, and the
    input's where it is needed."""
    ops = [matmul(k, m, n, "linear_dw")]
    if input_grad:
        ops.append(matmul(m, n, k, "linear_dx"))
    return ops


def elementwise(name: str, elems: int, reads: int = 1, writes: int = 1,
                flops_per: float = 1.0) -> Op:
    """An elementwise pass over `elems` float32 values, reading `reads`
    and writing `writes` arrays of that size."""
    return Op(name, flops_per * elems, F32 * elems * (reads + writes))


def spmm(n: int, e: int, h: int, name: str = "spmm") -> Op:
    """out[i] = sum over edges (j -> i) of w_e x[j], x: [n, h]: reads x,
    the senders, receivers and weights, writes out."""
    return Op(name, 2.0 * e * h, F32 * 2 * n * h + (2 * I64 + F32) * e)


def gcn_norm(n: int, e: int, loops: bool) -> Op:
    """The symmetric normalisation w_e / sqrt(d_s d_r): reads the edges,
    writes the degrees and the normalised weights (with the loops, where
    they are added, written once)."""
    e_out = e + n if loops else e
    written = F32 * (n + e_out) + (2 * I64 + F32) * (e_out - e)
    return Op("gcn_norm", 3.0 * e_out + n, (2 * I64 + F32) * e + written)


def gcn_encoder(n: int, e: int, dims: List[int], loops: bool) -> List[Op]:
    """One view through a GCN of widths `dims` (x W, then the normalised
    sparse aggregation, then bias and activation), forward and backward,
    with no input gradient at the first layer. `loops`: the layer adds a
    self-loop per node to the view's e edges."""
    agg = e + n if loops else e
    ops = [gcn_norm(n, e, loops)]
    for i in range(len(dims) - 1):
        h = dims[i + 1]
        ops += [matmul(n, dims[i], h), spmm(n, agg, h),
                elementwise("bias_act", n * h, 1, 1, 2.0)]
        ops += linear_bwd(n, dims[i], h, input_grad=i > 0)
        ops += [spmm(n, agg, h, "spmm_bwd"),
                elementwise("bias_act_bwd", n * h, 2, 1, 2.0)]
    return ops


def infonce(n: int, f: int) -> List[Op]:
    """One branch of identity-positive InfoNCE over [n, f] anchors and
    samples: the forward (a b^T, logsumexp, diagonal) and the gradients of
    both inputs, each recomputing a b^T: 2 n^2 f + 2 x 4 n^2 f FLOPs."""
    rows = F32 * n * f
    return [Op("infonce_fwd", 2.0 * n * n * f, 2 * rows + 2 * F32 * n),
            Op("infonce_bwd_da", 4.0 * n * n * f, 3 * rows + 2 * F32 * n),
            Op("infonce_bwd_db", 4.0 * n * n * f, 3 * rows + 2 * F32 * n)]


def l2norm(n: int, f: int) -> List[Op]:
    """Row normalisation, forward (read x, write y) and backward (read the
    gradient and x, write the input's gradient)."""
    return [elementwise("l2norm", n * f, 1, 1, 3.0),
            elementwise("l2norm_bwd", n * f, 2, 1, 5.0)]


def cca_loss(n: int, d: int) -> List[Op]:
    """CCA-SSG's loss on standardised [n, d] embeddings: z1^T z2, z1^T z1
    and z2^T z2, forward, and each product's two gradients."""
    ops = []
    for _ in range(3):
        ops.append(matmul(d, n, d, "cca_gram"))
        ops.append(matmul(n, d, d, "cca_gram_bwd"))
        ops.append(matmul(n, d, d, "cca_gram_bwd"))
    return ops
