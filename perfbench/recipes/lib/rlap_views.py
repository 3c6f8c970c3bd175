"""The check that the rLap recipes (GRACE, CCA-SSG) share: each recorded
view remade by the plain reference from its key, and the recorded views
paired two by two for the reference's steps."""

from __future__ import annotations

import torch

from perfbench import compare
from perfbench.harness import graph_dict, moved
from perfbench.reference import rlap as ref_rlap


def views(record) -> list:
    return [e for e in record if e.what == "view"]


def view_gap(inputs, record, frac: float, pf: float, plumbing: str,
             device, dt=torch.float64) -> float:
    """Views drawn from a key an earlier view drew from, plus the sum of
    `compare.view_diff` of each recorded view against the reference's
    view of its key: 0 when every view is the reference's. With `dt`
    below float64, the reference's own views at `dt` take the recorded
    views' place (the control)."""
    g = graph_dict(inputs, device)
    n = g["num_nodes"]
    vs = views(record)
    gap = float(compare.repeated_keys([e.key for e in vs]))
    for e in vs:
        ref_edges, ref_x = ref_rlap.view(g, e.key, frac, pf, plumbing)
        if dt == torch.float64:
            mine = moved(e.value, device)
        else:
            lo_e, lo_x = ref_rlap.view(g, e.key, frac, pf, plumbing, dt)
            mine = {"senders": lo_e // (n + 1), "receivers": lo_e % (n + 1),
                    "weights": torch.ones(lo_e.shape[0], device=device),
                    "x": lo_x, "num_nodes": n}
        gap += compare.view_diff(mine, ref_edges, ref_x)
    return gap


def pairs(record, device) -> list:
    """The recorded views on `device`, two by two in the order they were
    recorded: one training step's pair each."""
    vs = [moved(e.value, device) for e in views(record)]
    return [(vs[2 * i], vs[2 * i + 1]) for i in range(len(vs) // 2)]
