"""GRACE and CCA-SSG training steps, plain: the GCN encoder by gather and
`index_add_`, the projection head, row-blocked InfoNCE (each block
recomputed in the backward, so that no [n, n] matrix is held), CCA-SSG's
loss, and Adam with L2 decay written out. Parameters are a dict of
tensors named as the program's `state_dict` names them.

The equations are the configurations' (GRACE: Zhu et al. 2020 with the
identity-positive InfoNCE the program documents, the mean of both
directions; CCA-SSG: Zhang et al. 2021), in float32 with TF32 off. With
`tf32=True` every matrix product is taken in TF32 instead: the control.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Precision:
    """Matrix products in float32 (TF32 off), or in TF32: operands rounded
    to TF32 (on any device) and the card's TF32 mode on for the products
    autograd takes in the backward."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def __enter__(self):
        self._saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self._saved

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a = a + (tf32_round(a) - a).detach()
            b = b + (tf32_round(b) - b).detach()
        return a @ b


def prelu(x, slope):
    return torch.where(x >= 0, x, slope * x)


def gcn_layer(p: Params, prefix: str, g: dict, x, prec: Precision,
              loops: bool):
    """x W^T, then out[i] = sum over edges (j -> i) of w_e / sqrt(d_j d_i)
    of it, then the bias. With `loops`, self-loops of weight 1 replace any
    present; the degree is the weighted degree over senders."""
    n = g["num_nodes"]
    s, r, w = g["senders"], g["receivers"], g["weights"]
    live = s < n
    if loops:
        live = live & (s != r)
    s, r, w = s[live], r[live], w[live]
    if loops:
        ids = torch.arange(n, device=s.device)
        s, r = torch.cat([s, ids]), torch.cat([r, ids])
        w = torch.cat([w, torch.ones(n, dtype=w.dtype, device=w.device)])
    deg = torch.zeros(n, dtype=w.dtype, device=w.device).index_add_(0, s, w)
    dinv = torch.where(deg > 0, deg.clamp_min(1e-12).rsqrt(),
                       torch.zeros_like(deg))
    wn = w * dinv[s] * dinv[r]
    h = prec.mm(x, p[prefix + ".lin.weight"].T)
    out = torch.zeros(n, h.shape[1], dtype=h.dtype,
                      device=h.device).index_add(0, r, h[s] * wn[:, None])
    return out + p[prefix + ".bias"]


def l2norm(x, eps: float = 1e-8):
    return x * torch.rsqrt(torch.clamp((x * x).sum(-1, keepdim=True),
                                       min=eps * eps))


def _infonce_block(a_blk, b, diag_b, tau: float, tf32: bool):
    prec = Precision(tf32)
    sim = prec.mm(a_blk, b.T) / tau
    pos = (a_blk * diag_b).sum(-1) / tau
    return (pos - torch.logsumexp(sim, 1)).sum()


def infonce(anchor, sample, tau: float, prec: Precision,
            block: int = 2048):
    """-mean_i (s_ii - logsumexp_j s_ij), s = cos(anchor_i, sample_j) /
    tau, in blocks of anchor rows."""
    a, b = l2norm(anchor), l2norm(sample)
    n = a.shape[0]
    total = a.new_zeros(())
    for i0 in range(0, n, block):
        blk = slice(i0, i0 + block)
        total = total + checkpoint(_infonce_block, a[blk], b, b[blk], tau,
                                   prec.tf32, use_reentrant=False)
    return -total / n


def grace_loss(p: Params, g1: dict, g2: dict, tau: float,
               prec: Precision, layers: int, half: bool = False):
    """`half`: the loss over the first half of the anchors only (a fault
    of the calibration, not the reference)."""
    hs = []
    for g in (g1, g2):
        x = g["x"]
        for i in range(layers):
            x = prelu(gcn_layer(p, f"encoder.convs.{i}", g, x, prec, True),
                      p[f"encoder.acts.{i}.slope"])
        z = prec.mm(x, p["project.fc1.weight"].T) + p["project.fc1.bias"]
        z = prec.mm(F.elu(z), p["project.fc2.weight"].T) \
            + p["project.fc2.bias"]
        hs.append(z[:z.shape[0] // 2] if half else z)
    return 0.5 * (infonce(hs[0], hs[1], tau, prec)
                  + infonce(hs[1], hs[0], tau, prec))


def standardize(z, eps: float = 1e-8):
    n = z.shape[0]
    mean = z.mean(0)
    var = ((z - mean) ** 2).mean(0)
    return (z - mean) * torch.rsqrt(var * n + eps)


def cca_loss(p: Params, g1: dict, g2: dict, lam: float, prec: Precision,
             layers: int, half: bool = False):
    """-tr(z1^T z2) + lam (||I - z1^T z1||^2 + ||I - z2^T z2||^2) of the
    standardised embeddings; the views carry their self-loops already.
    `half`: over the first half of the nodes only (a fault of the
    calibration, not the reference)."""
    zs = []
    for g in (g1, g2):
        x = g["x"]
        for i in range(layers):
            x = gcn_layer(p, f"net.convs.{i}", g, x, prec, False)
            if i < layers - 1:
                x = prelu(x, p[f"net.prelu_{i}"])
        zs.append(standardize(x[:x.shape[0] // 2] if half else x))
    z1, z2 = zs
    eye = torch.eye(z1.shape[1], dtype=z1.dtype, device=z1.device)
    inv = -torch.trace(prec.mm(z1.T, z2))
    dec = ((eye - prec.mm(z1.T, z1)) ** 2).sum() \
        + ((eye - prec.mm(z2.T, z2)) ** 2).sum()
    return inv + lam * dec


def with_self_loops(g: dict) -> dict:
    """The view with one self-loop of weight 1 per node appended (CCA-SSG
    adds them to its views)."""
    n = g["num_nodes"]
    ids = torch.arange(n, device=g["senders"].device)
    return dict(g, senders=torch.cat([g["senders"], ids]),
                receivers=torch.cat([g["receivers"], ids]),
                weights=torch.cat([g["weights"],
                                   torch.ones(n, dtype=g["weights"].dtype,
                                              device=ids.device)]))


class Adam:
    """Adam with L2 decay added to the gradient before the moments."""

    def __init__(self, params: Params, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: Params, grads: Params) -> Params:
        """The gradients as the update takes them (decay added)."""
        b1, b2 = self.betas
        self.t += 1
        taken = {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            taken[k] = g
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            mh = self.m[k] / (1 - b1 ** self.t)
            vh = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * mh / (vh.sqrt() + self.eps))
        return taken


def train(loss_fn, params: Params, views: List[Tuple[dict, dict]],
          lr: float, weight_decay: float, tf32: bool = False):
    """Follow the program's first len(views) steps from the same weights
    on the same views. Returns (losses, the first step's gradients as
    Adam takes them, the parameters after the last step)."""
    p = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(p, lr, weight_decay)
    losses, first = [], None
    with Precision(tf32) as prec:
        for g1, g2 in views:
            leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
            loss = loss_fn(leaves, g1, g2, prec)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                taken = opt.step(p, dict(zip(leaves, grads)))
            if first is None:
                first = taken
    return losses, first, p
