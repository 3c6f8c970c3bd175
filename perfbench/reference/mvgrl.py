"""MVGRL's training step, plain (Hassani and Khasahmadi, ICML 2020,
arXiv 2006.05582): two dedicated GCN encoders, one a view, each with one
per-channel PReLU shared by its layers; DGI's corruption, each encoder
run again on its view's features with the rows permuted; the summaries
project(sigmoid(mean of z)); and the Jensen-Shannon graph-to-local loss,
each view's summary against the other view's nodes (positives) and the
other view's corrupted nodes (negatives). The parameters are a dict named
as the program's `state_dict` names them, the products in float32 with
TF32 off (`nets.Precision`). Adam is `nets.Adam`, through `nets.train`.

Departures from the published description, as the program departs:
- both views are cut to one node subset (`node_mask`, at least
  `subsample` nodes; the rLap recipe's 8192): the edges leaving it are
  dropped, the mean of the summary and the loss's nodes are the subset's,
  and the corruption permutes all n rows;
- the discriminator is the plain dot product of summary and node (the
  paper's is bilinear), and the JSD multiplies the similarity by the
  positive and negative masks before the softplus, as the JAX package
  and its reference do;
- the GCN adds self-loops of weight 1 in place of any present, on the
  diffusion view too (the paper feeds S without them).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import nets


def induced(g: dict, mask) -> dict:
    """The view with every edge that leaves `mask` made padding."""
    if mask is None:
        return g
    n = g["num_nodes"]
    s, r = g["senders"], g["receivers"]
    kp = torch.cat([mask, mask.new_zeros(1)])
    dead = ~((s < n) & kp[s] & kp[r])
    return dict(g, senders=torch.where(dead, n, s),
                receivers=torch.where(dead, n, r),
                weights=torch.where(dead, torch.zeros_like(g["weights"]),
                                    g["weights"]))


def encoder(p, prefix: str, g: dict, x, prec, layers: int):
    for i in range(layers):
        x = nets.prelu(nets.gcn_layer(p, f"{prefix}.convs.{i}", g, x, prec,
                                      True), p[f"{prefix}.act.slope"])
    return x


def summary(p, z, w, prec):
    m = (z * w[:, None]).sum(0, keepdim=True) / w.sum().clamp_min(1.0)
    return prec.mm(torch.sigmoid(m), p["project.weight"].T) \
        + p["project.bias"]


def jsd(anchor, sample, pos, neg, prec):
    log2 = math.log(2.0)
    sim = prec.mm(anchor, sample.T)
    e_pos = (log2 - F.softplus(-sim * pos)).sum() / pos.sum().clamp_min(1.0)
    neg_sim = sim * neg
    e_neg = (F.softplus(-neg_sim) + neg_sim - log2).sum() \
        / neg.sum().clamp_min(1.0)
    return e_neg - e_pos


def loss(p, v1: dict, v2: dict, prec, layers: int, half: bool = False):
    """One step's loss. Each view carries its `node_mask` (or None) and
    `perm`, the corruption's permutation. `half`: the nodes of the loss
    cut to the first half (a fault of the calibration, not the
    reference)."""
    n = v1["num_nodes"]
    mask = v1["node_mask"]
    w = (torch.ones(n, device=v1["x"].device) if mask is None
         else mask.to(torch.float32))
    if half:
        w = w * (torch.arange(n, device=w.device) < n // 2)
    zs, zc, ss = [], [], []
    for name, v in (("encoder1", v1), ("encoder2", v2)):
        g = induced(v, v["node_mask"])
        z = encoder(p, name, g, v["x"], prec, layers)
        zs.append(z)
        zc.append(encoder(p, name, g, v["x"][v["perm"]], prec, layers))
        ss.append(summary(p, z, w, prec))
    zero = torch.zeros_like(w)
    pos = torch.cat([w, zero])[None, :]
    neg = torch.cat([zero, w])[None, :]
    l1 = jsd(ss[0], torch.cat([zs[1], zc[1]]), pos, neg, prec)
    l2 = jsd(ss[1], torch.cat([zs[0], zc[0]]), pos, neg, prec)
    return 0.5 * (l1 + l2)
