"""rLap-then-PPR diffusion views, plain: the Schur complement with its
weights, the PPR series by dense products, and the top-k rule, written
again from their definitions.

- The complement: `rlap.schur_edges` (imported, not edited) makes the
  edge set from the view's key; its weights are the ones it sums last
  and does not return, kept here as they pass through its final
  `torch.cat`s. Duplicate edges sum, as a coalesce sums them.
- PPR (Page et al.; the diffusion of Klicpera et al., ICLR 2019, that
  MVGRL takes): S = alpha sum_k ((1 - alpha) T)^k, T = D^-1/2 A D^-1/2
  with D A's row sums and no self-loops added (an eliminated node is an
  empty row), as `iters` steps of S <- alpha I + (1 - alpha) T S from
  S = alpha I. Departure from the published description: the series is
  cut at `iters` steps, as the program cuts it, not solved exactly.
- The view: per row the k largest entries (value descending, then
  column ascending) that are at least eps, k = edge capacity // n.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.overrides import TorchFunctionMode

from perfbench.reference import keys, nets, rlap

ROW_BLOCK = 2048


class _LastCats(TorchFunctionMode):
    """Keeps the inputs of the last two `torch.cat` calls made inside it."""

    def __init__(self):
        super().__init__()
        self.cats = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.cat:
            self.cats = (self.cats + [list(args[0])])[-2:]
        return func(*args, **(kwargs or {}))


def schur_complement(g: dict, seed: int, frac: float, dt=torch.float64):
    """(sorted directed keys s * (n + 1) + r, their weights) of the
    Schur complement the key `seed` makes of the graph `g`: the edges of
    `rlap.schur_edges`, and the weights of its last two `torch.cat`s
    (`[s * big + r, r * big + s]` and `[w, w]`), summed per key."""
    n = g["num_nodes"]
    with _LastCats() as seen:
        edges = rlap.schur_edges(g["senders"], g["receivers"], g["weights"],
                                 n, int(frac * n),
                                 keys.generator(seed, g["senders"].device),
                                 dt)
    both, ws = (torch.cat(c) for c in seen.cats)
    uniq, inv = torch.unique(both, return_inverse=True)
    w = torch.zeros(uniq.shape[0], dtype=torch.float64,
                    device=both.device).index_add_(0, inv, ws.double())
    return edges, w[torch.searchsorted(uniq, edges)]


def ppr(senders, receivers, weights, n: int, alpha: float, iters: int,
        dt=torch.float64, tf32: bool = False) -> torch.Tensor:
    """The dense [n, n] S of a weighted graph given by its live edges,
    in `dt`; with `tf32` (float32 only), each product's operands rounded
    to TF32 first, on any device (the control)."""
    a = torch.zeros(n, n, dtype=dt, device=senders.device)
    a.index_put_((senders, receivers), weights.to(dt), accumulate=True)
    d = a.sum(1)
    dinv = torch.where(d > 0, d.clamp_min(1e-300).rsqrt(),
                       torch.zeros_like(d))
    t = a.mul_(dinv[:, None]).mul_(dinv[None, :])
    low = nets.tf32_round if tf32 else (lambda x: x)
    t = low(t)
    s = torch.eye(n, dtype=dt, device=a.device).mul_(alpha)
    for _ in range(iters):
        s = torch.mm(t, low(s)).mul_(1 - alpha)
        s.diagonal().add_(alpha)
    return s


def top_k(s: torch.Tensor, k: int, eps: float) -> Tuple[torch.Tensor, ...]:
    """(rows, columns, values) of the view of S: per row the k largest
    entries, ties to the lower column, those at least eps."""
    rows, cols, vals = [], [], []
    for i0 in range(0, s.shape[0], ROW_BLOCK):
        v, c = torch.sort(s[i0:i0 + ROW_BLOCK], dim=1, descending=True,
                          stable=True)
        v, c = v[:, :k], c[:, :k]
        r = torch.arange(i0, i0 + v.shape[0], device=s.device)[:, None]
        keep = v >= eps
        rows.append(r.expand_as(c)[keep])
        cols.append(c[keep])
        vals.append(v[keep])
    return torch.cat(rows), torch.cat(cols), torch.cat(vals)


def view_gaps(s: torch.Tensor, rows, cols, vals, k: int, eps: float,
              tie: float) -> Tuple[float, int]:
    """How far a view (its live entries) is from S's view: the largest
    relative gap of a kept weight to S's entry, and the count of entries
    that a near-tie cannot explain: a row with more than k entries or an
    entry twice; a kept entry under eps (1 - tie); a dropped entry over
    (1 + tie) times the row's bar, which is its least kept entry of S
    where it keeps k, else eps."""
    n = s.shape[0]
    ref = s[rows, cols]
    gap = float(((vals.to(s.dtype) - ref).abs()
                 / ref.abs().clamp_min(1e-300)).max()) if rows.numel() else 0.0
    key = torch.unique(rows * n + cols)
    wrong = rows.numel() - key.numel()
    count = torch.bincount(rows, minlength=n)
    wrong += int((count - k).clamp_min(0).sum())
    wrong += int((ref < eps * (1 - tie)).sum())
    least = torch.full((n,), float("inf"), dtype=s.dtype, device=s.device)
    least = least.scatter_reduce(0, rows, ref, "amin")
    bar = torch.where(count >= k, least, torch.full_like(least, eps))
    for i0 in range(0, n, ROW_BLOCK):
        blk = s[i0:i0 + ROW_BLOCK]
        kept = torch.zeros_like(blk, dtype=torch.bool)
        sel = (rows >= i0) & (rows < i0 + blk.shape[0])
        kept[rows[sel] - i0, cols[sel]] = True
        over = blk > (bar[i0:i0 + blk.shape[0], None] * (1 + tie))
        wrong += int((over & ~kept).sum())
    return gap, wrong
