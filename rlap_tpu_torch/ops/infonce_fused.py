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

_STEM = "infonce"
SOURCE = _build.source_path(_STEM)
KERNELS = ("infonce_fwd", "infonce_bwd_da", "infonce_bwd_db")

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
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.infonce_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, f32, ptr]
    for name in ("infonce_bwd_da", "infonce_bwd_db"):
        getattr(lib, name).argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                       f32, ptr]
    for name in KERNELS:
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


def _coef_rows(a, b, lse, g, i0: int, block: int, tau: float):
    sim = _sim_rows(a, b, i0, block, tau)
    coef = -torch.exp(sim - lse[i0:i0 + block, None])
    coef.diagonal(offset=i0).add_(1.0)
    return coef * (g[i0:i0 + block, None] * (1.0 / tau))


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


def _bwd_3xtf32_plain(p, q, lse, g, tau: float, block: int, tile: int,
                      db: bool) -> torch.Tensor:
    """The gradient kernels' arithmetic. A block owns `block` rows of p (A
    for dA, B for dB) and streams the rows of q (B, A) in tiles of `tile`;
    r is the row of q at the block's first own index.

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
      n=20000 on alike rows."""
    n, f = p.shape
    nb, nt = -(-n // block), -(-n // tile)
    m = max(nb * block, nt * tile)

    def padded(x):  # zero rows past n
        out = x.new_zeros((m,) + tuple(x.shape[1:]))
        out[:n] = x
        return out

    pb = padded(p)[:nb * block].view(nb, block, f)
    qp, lse_p, g_p = padded(q), padded(lse), padded(g)
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
        anchor = cols if db else rows  # the index i of lse_i and g_i
        coef = -torch.exp(s * (1.0 / tau) - lse_p[anchor])
        coef = coef + (rows == cols).to(coef.dtype)
        coef = coef * (g_p[anchor] * (1.0 / tau)) * (cols < n).to(coef.dtype)
        for part in matmul_3xtf32(coef, v.mT).unbind(1):  # tile by tile
            total += part
        if db:
            c64 += coef.sum(-1).double().sum(1)
    if db:
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
    return _bwd_3xtf32_plain(a, b, lse, g, tau, block, tile, db=False)


def infonce_bwd_db_3xtf32_plain(a, b, lse, g, tau: float, block: int = 64,
                                tile: int = 32):
    """`infonce_bwd_db_plain` in the kernels' arithmetic
    (`_bwd_3xtf32_plain`): a block of rows of B sums coef_ij (A_i - r) over
    tiles of 32 rows of A, with r = A[j0] at the block's first own index
    j0, and adds back r c_j, c_j = sum_i coef_ij in float64. The column
    sums are not 0, so without r c_j the shift would change the result;
    and their rounding, through r c_j, is what limits dB on alike rows (the
    tests hold it to 2e-4 of the largest entry at spread 0.003)."""
    return _bwd_3xtf32_plain(b, a, lse, g, tau, block, tile, db=True)


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
