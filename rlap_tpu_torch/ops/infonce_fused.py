"""Fused identity-positive InfoNCE: three hand-written CUDA kernels for
Hopper, their plain PyTorch versions, and the autograd wiring.

Counterpart of `rlap_tpu/ops/infonce_pallas.py`. The kernels
(`rlap_tpu_torch/csrc/infonce.cu`) replace the Pallas TPU kernels
`_fwd_kernel`, `_bwd_da_kernel` and `_bwd_db_kernel`; the source says what
bounds them on the H100 and how they are laid out. All three run on the
tensor cores in three TF32 passes on split operands ("3xTF32"), which
keeps float32 accuracy: through `wgmma` where f <= 128, f % 4 == 0 and the
rows are 16-byte aligned, through `mma.sync` at other widths.
`tf32_round`, `tf32_truncate`, `matmul_3xtf32` and the three
`*_3xtf32_plain` functions emulate that arithmetic in plain PyTorch, for
tests: nothing else calls them.

Each kernel wrapper (`infonce_fwd`, `infonce_bwd_da`, `infonce_bwd_db`)
runs the plain version for a tensor on the CPU and launches the kernel for
a CUDA tensor, or raises: there is no fallback on the card. Each launch
adds one to `launch_counts[name]`, so a run can show that it went through
the kernels. They keep a block's rows resident in shared memory, which
bounds the width: f <= 1920, and a wider launch is refused with a CUDA
error.

The pair. The dual-branch loss 0.5 (l(a, b) + l(b, a)) takes its second
direction on the transpose of the first's similarity matrix, so one
forward (`infonce_fwd_pair`: row and column logsumexps of one pass) and
two gradient launches (`infonce_bwd_pair`, once a side) make both
directions, where the one-way kernels take two forwards and four
gradients. `InfoNCEPair` wires them; `infonce_pair` takes it where the
shape rule of the `wgmma` kernels allows (`takes_pair`), else two
`InfoNCECore`, and `infonce_fused_pair` is the loss. Their launches count
under `PAIR_KERNELS`, so that `KERNELS` keeps counting the one-way three.

The library is built from the repository's source at first use and loaded
with ctypes, by `rlap_tpu_torch/ops/_build.py`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from rlap_tpu_torch.ops import _build
from rlap_tpu_torch.ops._build import BUILD_DIR  # noqa: F401
from rlap_tpu_torch.ops._build import on_cpu as _on_cpu
from rlap_tpu_torch.utils import tracing

_STEM = "infonce"
SOURCE = _build.source_path(_STEM)
KERNELS = ("infonce_fwd", "infonce_bwd_da", "infonce_bwd_db")
PAIR_KERNELS = ("infonce_fwd_pair", "infonce_bwd_pair")

launch_counts = {name: 0 for name in KERNELS + PAIR_KERNELS}

# rows of A a block of the pair forward owns: its workspace holds one row
# of column sums for each block
PAIR_FWD_ROWS = 128
# The pair forward shifts every logit by 1/tau in place of a running max;
# its smallest term, exp(-2/tau), is a normal float32 (e^-80 > 2^-126)
# from this tau on. Below it the pair takes two one-way forwards.
PAIR_FWD_MIN_TAU = 0.025


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def library_path() -> Path:
    return _build.library_path(_STEM)


def build(extra_flags: Tuple[str, ...] = ()) -> Tuple[Path, str]:
    """Compile the kernels unless a library of this source exists.
    Returns (library path, compiler output)."""
    return _build.build(_STEM, extra_flags)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.infonce_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, f32, ptr]
    for name in ("infonce_bwd_da", "infonce_bwd_db"):
        getattr(lib, name).argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                       f32, ptr]
    lib.infonce_fwd_pair.argtypes = [ptr] * 8 + [i32, i32, f32, ptr]
    lib.infonce_bwd_pair.argtypes = [ptr] * 7 + [i32, i32, f32, ptr]
    for name in KERNELS + PAIR_KERNELS:
        getattr(lib, name).restype = ctypes.c_int


def _launch(name: str, *tensors: torch.Tensor, n: int, f: int,
            tau: float) -> None:
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous float32 tensors, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")
    _build.launch(_STEM, _declare, name, tensors, n, f, 1.0 / tau)
    launch_counts[name] += 1


def _check_shapes(a, b, *rows):
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"anchor/sample shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    for t in rows:
        if t.shape != (a.shape[0],):
            raise ValueError(f"per-row tensor of shape {tuple(t.shape)} for "
                             f"n={a.shape[0]}")


# ---------------------------------------------------------------------------
# plain versions: row-blocked A.B^T/tau, logsumexp and the diagonal
# ---------------------------------------------------------------------------

def _matmul_t(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return p @ q.T


def _sim_rows(a, b, i0: int, block: int, tau: float,
              matmul_t=_matmul_t) -> torch.Tensor:
    return matmul_t(a[i0:i0 + block], b) * (1.0 / tau)


def infonce_fwd_plain(a, b, tau: float, block: int = 1024,
                      matmul_t=_matmul_t):
    """(out, lse): lse_i = logsumexp_j sim_ij, out_i = sim_ii - lse_i."""
    outs, lses = [], []
    for i0 in range(0, a.shape[0], block):
        sim = _sim_rows(a, b, i0, block, tau, matmul_t)
        lse = torch.logsumexp(sim, 1)
        outs.append(sim.diagonal(offset=i0) - lse)
        lses.append(lse)
    return torch.cat(outs), torch.cat(lses)


def _coef(sim, lse, g, i0: int, tau: float):
    """(g / tau) (1[i == j] - exp(sim - lse)) on rows i0.. of sim, with
    lse and g shaped to broadcast: [rows, 1] for the rows' anchors, [n]
    for the columns'."""
    coef = -torch.exp(sim - lse)
    coef.diagonal(offset=i0).add_(1.0)
    return coef * (g * (1.0 / tau))


def _coef_rows(a, b, lse, g, i0: int, block: int, tau: float):
    return _coef(_sim_rows(a, b, i0, block, tau), lse[i0:i0 + block, None],
                 g[i0:i0 + block, None], i0, tau)


def infonce_bwd_da_plain(a, b, lse, g, tau: float, block: int = 1024):
    """dA_i = sum_j coef_ij B_j."""
    return torch.cat([_coef_rows(a, b, lse, g, i0, block, tau) @ b
                      for i0 in range(0, a.shape[0], block)])


def infonce_bwd_db_plain(a, b, lse, g, tau: float, block: int = 1024):
    """dB_j = sum_i coef_ij A_i."""
    db = torch.zeros_like(b)
    for i0 in range(0, a.shape[0], block):
        db += _coef_rows(a, b, lse, g, i0, block, tau).T @ a[i0:i0 + block]
    return db


def infonce_fwd_pair_plain(a, b, tau: float, block: int = 1024,
                           matmul_t=_matmul_t):
    """(out1, lse1, out2, lse2) of both directions from one row-blocked
    pass over sim = a b^T / tau: lse1 its row logsumexps, lse2 its column
    ones, out1 = diag - lse1 and out2 = diag - lse2."""
    diags, lses, col = [], [], None
    for i0 in range(0, a.shape[0], block):
        sim = _sim_rows(a, b, i0, block, tau, matmul_t)
        diags.append(sim.diagonal(offset=i0).clone())  # not a view of sim
        lses.append(torch.logsumexp(sim, 1))
        part = torch.logsumexp(sim, 0)
        col = part if col is None else torch.logaddexp(col, part)
    diag, lse1 = torch.cat(diags), torch.cat(lses)
    return diag - lse1, lse1, diag - col, col


def infonce_bwd_pair_plain(p, q, lse_own, g_own, lse_str, g_str,
                           tau: float, block: int = 1024):
    """The pair's gradient for the rows of p: sum_j G_ij q_j with
    G_ij = (g_own_i / tau) (1[i == j] - exp(sim_ij - lse_own_i))
         + (g_str_j / tau) (1[i == j] - exp(sim_ij - lse_str_j)),
    sim = p q^T / tau. (p, q) = (a, b) with (lse1, g1 | lse2, g2) gives
    dA of the pair, (b, a) with (lse2, g2 | lse1, g1) dB."""
    out = []
    for i0 in range(0, p.shape[0], block):
        sim = _sim_rows(p, q, i0, block, tau)
        coef = (_coef(sim, lse_own[i0:i0 + block, None],
                      g_own[i0:i0 + block, None], i0, tau)
                + _coef(sim, lse_str, g_str, i0, tau))
        out.append(coef @ q)
    return torch.cat(out)


# ---------------------------------------------------------------------------
# the kernels' arithmetic in plain PyTorch, for tests
# ---------------------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero, by integer arithmetic on the bit pattern: what
    `cvt.rna.tf32.f32` does. Infinities and NaNs pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """float32 cut to TF32's 10 mantissa bits: what the tensor cores read
    of a float32 operand that was not rounded first."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p @ q.T as the kernels take it: each operand x is split into
    hi = x rounded to TF32 and lo = x - hi as the tensor cores read it, and
    the product is lo_p hi_q + hi_p lo_q + hi_p hi_q, summed in float32. A
    product of two TF32 values is exact in float32, so this is the
    `mma.sync` kernels' arithmetic up to the order of the sums (and to ties
    in the rounding of hi, which they break to even). The `wgmma` kernels
    cut hi and round lo instead, with the same bound
    |x - hi - lo| <= 2^-21 |x|."""
    p_hi, q_hi = tf32_round(p), tf32_round(q)
    p_lo, q_lo = tf32_truncate(p - p_hi), tf32_truncate(q - q_hi)
    return p_lo @ q_hi.mT + p_hi @ q_lo.mT + p_hi @ q_hi.mT


def infonce_fwd_3xtf32_plain(a, b, tau: float, block: int = 1024):
    """`infonce_fwd_plain` with the 3xTF32 product."""
    return infonce_fwd_plain(a, b, tau, block, matmul_3xtf32)


def infonce_fwd_pair_3xtf32_plain(a, b, tau: float):
    """The pair forward kernel's arithmetic: the 3xTF32 product, and sums
    of e = exp(sim - 1/tau), a fixed shift in place of the running max,
    along each row of a block of 128 rows in float32 and down each column
    over the block in float32, the blocks' column sums added in float64.
    lse = 1/tau + log(sum)."""
    n = a.shape[0]
    diags, rows = [], []
    cols = torch.zeros(n, dtype=torch.float64, device=a.device)
    for i0 in range(0, n, PAIR_FWD_ROWS):
        s = matmul_3xtf32(a[i0:i0 + PAIR_FWD_ROWS], b)
        diags.append(s.diagonal(offset=i0) * (1.0 / tau))
        e = torch.exp((s - 1.0) * (1.0 / tau))
        rows.append(e.sum(1))
        cols += e.sum(0).double()
    diag = torch.cat(diags)
    lse1 = 1.0 / tau + torch.log(torch.cat(rows))
    lse2 = (1.0 / tau + torch.log(cols)).to(a.dtype)
    return diag - lse1, lse1, diag - lse2, lse2


def _bwd_3xtf32_plain(p, q, own, streamed, tau: float, block: int,
                      tile: int) -> torch.Tensor:
    """The gradient kernels' arithmetic. A block owns `block` rows of p (A
    for dA, B for dB) and streams the rows of q (B, A) in tiles of `tile`;
    r is the row of q at the block's first own index. `own` is (lse, g)
    of the anchors that are p's rows (dA, the pair) or None, `streamed`
    that of q's rows (dB, the pair) or None.

    - The similarity of a tile is taken against q - r, in 3xTF32, and
      t = p . r (float64, kept as float32 hi + lo) is added back to it:
      the tensor cores truncate as they add, and near |s| = 1 that biases
      every similarity alike, which a coefficient turns into the same
      relative error for every anchor (dB's sum does not cancel it).
    - Each tile's product coef . (q_tile - r) starts from zero and is added
      to a float32 total (the two-level sum).
    - dA: a row's coefficients sum to 0, so the total is dA.
    - dB: a column's coefficients sum to c_j != 0 (the softmax runs over
      the other index), so the total is dB_j - r c_j, and r c_j is added
      back. c_j is summed in float32 within a tile and in float64 across
      tiles: a float32 running total of c_j costs more than it saves at
      n=20000 on alike rows.
    - The pair: the streamed anchors' terms do not sum to 0 either, so r
      c_j is added back, c_j the sum of those terms alone. The owned
      anchors' terms sum to 0, as dA's, so what their sum is off by
      rounding stays out of c_j and out of the result."""
    n, f = p.shape
    nb, nt = -(-n // block), -(-n // tile)
    m = max(nb * block, nt * tile)

    def padded(x):  # zero rows past n
        out = x.new_zeros((m,) + tuple(x.shape[1:]))
        out[:n] = x
        return out

    pb = padded(p)[:nb * block].view(nb, block, f)
    qp = padded(q)
    anchors = [(padded(pair[0]), padded(pair[1]), side)
               for side, pair in (("rows", own), ("cols", streamed))
               if pair is not None]
    r = q[torch.arange(nb, device=q.device) * block]          # [nb, f]
    t = (pb.double() * r[:, None].double()).sum(-1)
    t_hi = t.float()
    t_lo = (t - t_hi.double()).float()
    rows = torch.arange(nb * block, device=p.device).view(nb, 1, block, 1)
    total = p.new_zeros(nb, block, f)
    c64 = torch.zeros(nb, block, dtype=torch.float64, device=p.device)
    per = max(1, (1 << 22) // (nb * block * tile))  # tiles at once: ~4M s
    for i0 in range(0, nt * tile, per * tile):
        k = min(per, nt - i0 // tile)
        cols = torch.arange(i0, i0 + k * tile, device=p.device)
        cols = cols.view(k, 1, tile)
        v = (qp[i0:i0 + k * tile].view(1, k, tile, f)
             - r.view(nb, 1, 1, f))                    # [nb, k, tile, f]
        s = matmul_3xtf32(pb[:, None], v)              # [nb, k, block, tile]
        s = (s + t_lo[:, None, :, None]) + t_hi[:, None, :, None]
        terms = {}
        for lse_p, g_p, side in anchors:
            anchor = rows if side == "rows" else cols  # i of lse_i, g_i
            term = -torch.exp(s * (1.0 / tau) - lse_p[anchor])
            term = term + (rows == cols).to(term.dtype)
            terms[side] = (term * (g_p[anchor] * (1.0 / tau))
                           * (cols < n).to(term.dtype))
        coef = sum(terms.values())
        for part in matmul_3xtf32(coef, v.mT).unbind(1):  # tile by tile
            total += part
        if streamed is not None:
            c64 += terms["cols"].sum(-1).double().sum(1)
    if streamed is not None:
        total = (total.double() + c64[..., None] * r[:, None].double()
                 ).to(p.dtype)
    return total.reshape(nb * block, f)[:n]


def infonce_bwd_da_3xtf32_plain(a, b, lse, g, tau: float, block: int = 64,
                                tile: int = 32):
    """`infonce_bwd_da_plain` in the kernels' arithmetic
    (`_bwd_3xtf32_plain`): a block of rows of A sums coef_ij (B_j - r)
    with r its first row of B. The coefficients of a row sum to 0 when lse
    is the row's logsumexp, so this is dA, and no term is larger than the
    rows' differences."""
    return _bwd_3xtf32_plain(a, b, (lse, g), None, tau, block, tile)


def infonce_bwd_db_3xtf32_plain(a, b, lse, g, tau: float, block: int = 64,
                                tile: int = 32):
    """`infonce_bwd_db_plain` in the kernels' arithmetic
    (`_bwd_3xtf32_plain`): a block of rows of B sums coef_ij (A_i - r) over
    tiles of 32 rows of A, with r = A[j0] at the block's first own index
    j0, and adds back r c_j, c_j = sum_i coef_ij in float64. The column
    sums are not 0, so without r c_j the shift would change the result;
    and their rounding, through r c_j, is what limits dB on alike rows (the
    tests hold it to 2e-4 of the largest entry at spread 0.003)."""
    return _bwd_3xtf32_plain(b, a, None, (lse, g), tau, block, tile)


def infonce_bwd_pair_3xtf32_plain(p, q, lse_own, g_own, lse_str, g_str,
                                  tau: float, block: int = 64,
                                  tile: int = 32):
    """`infonce_bwd_pair_plain` in the kernels' arithmetic
    (`_bwd_3xtf32_plain`): a block of rows of p sums G_ij (q_j - r) with
    both anchors' terms in G and adds back r c_i, c_i the sum over j of
    the streamed anchors' terms in float64, on either side: (a, b) for dA
    of the pair, (b, a) for dB."""
    return _bwd_3xtf32_plain(p, q, (lse_own, g_own), (lse_str, g_str), tau,
                             block, tile)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def infonce_fwd(a: torch.Tensor, b: torch.Tensor, tau: float):
    """(out, lse) of the forward kernel; the plain version on the CPU."""
    _check_shapes(a, b)
    if _on_cpu(a, b):
        return infonce_fwd_plain(a, b, tau)
    n, f = a.shape
    out = torch.empty(n, dtype=torch.float32, device=a.device)
    lse = torch.empty(n, dtype=torch.float32, device=a.device)
    _launch("infonce_fwd", a, b, out, lse, n=n, f=f, tau=tau)
    return out, lse


def _grad(name: str, plain, a, b, lse, g, tau: float) -> torch.Tensor:
    _check_shapes(a, b, lse, g)
    if _on_cpu(a, b, lse, g):
        return plain(a, b, lse, g, tau)
    grad = torch.empty_like(a)
    _launch(name, a, b, lse, g, grad, n=a.shape[0], f=a.shape[1], tau=tau)
    return grad


def infonce_bwd_da(a, b, lse, g, tau: float) -> torch.Tensor:
    """dA of the backward kernel; the plain version on the CPU."""
    return _grad("infonce_bwd_da", infonce_bwd_da_plain, a, b, lse, g, tau)


def infonce_bwd_db(a, b, lse, g, tau: float) -> torch.Tensor:
    """dB of the backward kernel; the plain version on the CPU."""
    return _grad("infonce_bwd_db", infonce_bwd_db_plain, a, b, lse, g, tau)


class InfoNCECore(torch.autograd.Function):
    """Per-row sim_ii - lse_i of normalised [n, f] float32 inputs, with the
    kernels as forward and backward (the JAX package's `_core` custom VJP).
    """

    @staticmethod
    def forward(ctx, a, b, tau: float):
        out, lse = infonce_fwd(a, b, tau)
        ctx.save_for_backward(a, b, lse)
        ctx.tau = tau
        return out

    @staticmethod
    def backward(ctx, g_out):
        a, b, lse = ctx.saved_tensors
        g = g_out.contiguous().to(torch.float32)
        da = (infonce_bwd_da(a, b, lse, g, ctx.tau)
              if ctx.needs_input_grad[0] else None)
        db = (infonce_bwd_db(a, b, lse, g, ctx.tau)
              if ctx.needs_input_grad[1] else None)
        return da, db, None


def infonce_fwd_pair(a: torch.Tensor, b: torch.Tensor, tau: float):
    """(out1, lse1, out2, lse2) of the pair forward kernel (both
    directions); the plain version on the CPU."""
    _check_shapes(a, b)
    if _on_cpu(a, b):
        return infonce_fwd_pair_plain(a, b, tau)
    n, f = a.shape
    out1, lse1, out2, lse2, diag = (
        torch.empty(n, dtype=torch.float32, device=a.device)
        for _ in range(5))
    ws = torch.empty(-(-n // PAIR_FWD_ROWS), n, dtype=torch.float32,
                     device=a.device)
    _launch("infonce_fwd_pair", a, b, out1, lse1, out2, lse2, diag, ws, n=n,
            f=f, tau=tau)
    return out1, lse1, out2, lse2


def infonce_bwd_pair(p, q, lse_own, g_own, lse_str, g_str,
                     tau: float) -> torch.Tensor:
    """The pair's gradient for the rows of p (`infonce_bwd_pair_plain`)
    from the pair gradient kernel; the plain version on the CPU."""
    _check_shapes(p, q, lse_own, g_own, lse_str, g_str)
    if _on_cpu(p, q, lse_own, g_own, lse_str, g_str):
        return infonce_bwd_pair_plain(p, q, lse_own, g_own, lse_str, g_str,
                                      tau)
    grad = torch.empty_like(p)
    _launch("infonce_bwd_pair", p, q, lse_own, g_own, lse_str, g_str, grad,
            n=p.shape[0], f=p.shape[1], tau=tau)
    return grad


class InfoNCEPair(torch.autograd.Function):
    """(out1, out2): the per-row values of both directions, sim_ii - lse1_i
    and sim_jj - lse2_j, of normalised [n, f] float32 inputs, with one
    pair forward and a pair gradient launch for each input. Below
    `PAIR_FWD_MIN_TAU` the forward is two one-way launches."""

    @staticmethod
    def forward(ctx, a, b, tau: float):
        if tau >= PAIR_FWD_MIN_TAU:
            out1, lse1, out2, lse2 = infonce_fwd_pair(a, b, tau)
        else:
            (out1, lse1), (out2, lse2) = (infonce_fwd(a, b, tau),
                                          infonce_fwd(b, a, tau))
        ctx.save_for_backward(a, b, lse1, lse2)
        ctx.tau = tau
        return out1, out2

    @staticmethod
    def backward(ctx, g_out1, g_out2):
        a, b, lse1, lse2 = ctx.saved_tensors
        g1 = g_out1.contiguous().to(torch.float32)
        g2 = g_out2.contiguous().to(torch.float32)
        da = (infonce_bwd_pair(a, b, lse1, g1, lse2, g2, ctx.tau)
              if ctx.needs_input_grad[0] else None)
        db = (infonce_bwd_pair(b, a, lse2, g2, lse1, g1, ctx.tau)
              if ctx.needs_input_grad[1] else None)
        return da, db, None


def takes_pair(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The shape rule of the pair kernels, those of the `wgmma` kernels:
    f <= 128, f % 4 == 0 and 16-byte aligned rows."""
    f = a.shape[1]
    return (f <= 128 and f % 4 == 0 and a.data_ptr() % 16 == 0
            and b.data_ptr() % 16 == 0)


def infonce_pair(a: torch.Tensor, b: torch.Tensor, tau: float):
    """(out1, out2) of both directions on normalised float32 a and b: the
    pair where `takes_pair`, else two `InfoNCECore` (the one-way kernels).
    While a profiler records, the counter `infonce.pair` adds 1 for the
    pair and 0 for the one-way kernels."""
    if takes_pair(a, b):
        tracing.count("infonce.pair", 1)
        return InfoNCEPair.apply(a, b, tau)
    tracing.count("infonce.pair", 0)
    return InfoNCECore.apply(a, b, tau), InfoNCECore.apply(b, a, tau)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def l2norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp((x * x).sum(-1, keepdim=True),
                                       min=eps * eps))


def masked_mean_loss(per_row: torch.Tensor,
                     anchor_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """-(sum of per_row over valid anchors) / max(#valid, 1)."""
    if anchor_mask is None:
        return -per_row.mean()
    m = anchor_mask.to(per_row.dtype)
    return -(per_row * m).sum() / torch.clamp(m.sum(), min=1.0)


def infonce_fused(anchor: torch.Tensor, sample: torch.Tensor,
                  tau: float = 0.2,
                  anchor_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Identity-positive InfoNCE: the mean over valid anchors of
    -(sim_ii - logsumexp_j sim_ij) on cosine similarities / tau. The L2
    normalisation and the masked mean are plain autograd around the
    kernels; nothing is padded."""
    a = l2norm(anchor.to(torch.float32)).contiguous()
    b = l2norm(sample.to(torch.float32)).contiguous()
    return masked_mean_loss(InfoNCECore.apply(a, b, float(tau)), anchor_mask)


def infonce_fused_pair(h1: torch.Tensor, h2: torch.Tensor, tau: float = 0.2,
                       anchor_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The dual-branch identity InfoNCE, 0.5 (l(h1, h2) + l(h2, h1)) with
    `infonce_fused`'s l, through `infonce_pair`: one pair of launches for
    both directions where the shape rule allows. `anchor_mask` masks the
    anchors of both directions."""
    a = l2norm(h1.to(torch.float32)).contiguous()
    b = l2norm(h2.to(torch.float32)).contiguous()
    out1, out2 = infonce_pair(a, b, float(tau))
    return 0.5 * (masked_mean_loss(out1, anchor_mask)
                  + masked_mean_loss(out2, anchor_mask))


def infonce_fused_plain(anchor: torch.Tensor, sample: torch.Tensor,
                        tau: float = 0.2,
                        anchor_mask: Optional[torch.Tensor] = None,
                        block_size: int = 1024) -> torch.Tensor:
    """The plain version of `infonce_fused`: the row-blocked forward, with
    autograd's backward."""
    a = l2norm(anchor.to(torch.float32))
    b = l2norm(sample.to(torch.float32))
    out, _ = infonce_fwd_plain(a, b, float(tau), block_size)
    return masked_mean_loss(out, anchor_mask)
