"""The numbers that decide `correct`: each a gap between what the program
produced and what the plain reference gives, compared with its limit in
`checks/<cell>.json` (how each limit was set is in `PERF.md`)."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable

import torch

# a leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone: left out of `change_gap`
STILL_LEAF = 1e-3


def view_diff(prog: dict, ref_edges: torch.Tensor,
              ref_x: torch.Tensor) -> float:
    """The edges in one view and not the other, plus live edges whose
    weight is not 1 or that repeat, over the reference's edges; plus the
    feature columns that differ anywhere, over the columns. 0 when the view is the
    reference's, edge for edge and bit for bit."""
    n = prog["num_nodes"]
    s, r, w = prog["senders"], prog["receivers"], prog["weights"]
    live = s < n
    mine = torch.unique(s[live] * (n + 1) + r[live])
    bad_w = int((w[live] != 1).sum())
    shared = int(torch.isin(mine, ref_edges).sum())
    twice = int(live.sum()) - mine.numel()
    differ = (mine.numel() - shared) + (ref_edges.numel() - shared) + bad_w \
        + twice
    cols = (prog["x"] != ref_x).any(0)
    return differ / max(ref_edges.numel(), 1) + float(cols.float().mean())


def repeated_keys(seeds) -> int:
    """Views drawn from a key that an earlier view of the run drew from (a
    key chain that does not advance repeats its views)."""
    return len(seeds) - len(set(seeds))


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def worst_leaf_gap(prog: Dict[str, torch.Tensor],
                   ref: Dict[str, torch.Tensor],
                   names: Iterable[str]) -> float:
    """max over leaves of |norm(prog leaf) - norm(ref leaf)| over the
    larger of the reference leaf's norm and the median leaf's. A leaf the
    program does not report (a state it never made) counts as norm 0."""
    rn = _norms(ref)
    med = statistics.median(rn.values())
    worst = 0.0
    for k in names:
        p = float(prog[k].double().norm()) if k in prog else 0.0
        den = max(rn[k], med)
        gap = abs(p - rn[k]) / den if den > 0 else (0.0 if p == 0 else 1.0)
        worst = max(worst, gap)
    return worst


def moving_leaves(ref_grad: Dict[str, torch.Tensor]):
    """The leaves whose first reference gradient is at least STILL_LEAF of
    the median leaf's."""
    gn = _norms(ref_grad)
    med = statistics.median(gn.values())
    return [k for k, v in gn.items() if v >= STILL_LEAF * med]


def train_gaps(prog_losses, ref_losses, prog_grad, ref_grad, prog_delta,
               ref_delta) -> Dict[str, float]:
    """`loss_gap`: the largest relative gap of a step's loss.
    `grad_gap`: the worst leaf's gap in the norm of the first gradient as
    Adam takes it. `change_gap`: the worst moving leaf's gap in the norm
    of the parameters' change over the checked steps."""
    if len(prog_losses) != len(ref_losses):
        return {"loss_gap": math.inf, "grad_gap": math.inf,
                "change_gap": math.inf}
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog_losses, ref_losses))
    if not all(math.isfinite(a) for a in prog_losses):
        loss = math.inf
    return {"loss_gap": loss,
            "grad_gap": worst_leaf_gap(prog_grad, ref_grad, ref_grad),
            "change_gap": worst_leaf_gap(prog_delta, ref_delta,
                                         moving_leaves(ref_grad))}
