"""Contrastive objectives: InfoNCE with its row-blocked and fused forms,
JSD, BootstrapLatent, and the dual-branch L2L, G2G and G2L wiring.
Counterpart of `rlap_tpu/objectives/contrast.py`. Everything is masked, so
padded (batched-graph) inputs work.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from rlap_tpu_torch.ops.infonce_fused import (infonce_fused_pair,
                                              infonce_fused_plain, l2norm)

_LOSSES = ("infonce", "infonce_batched", "infonce_fused", "auto", "jsd",
           "bootstrap")
_IDENTITY_LOSSES = ("infonce_batched", "infonce_fused", "auto")
_MODES = ("L2L", "G2G", "G2L")


def cosine_similarity_matrix(a: torch.Tensor, b: torch.Tensor):
    return l2norm(a) @ l2norm(b).T


def same_scale_masks(n: int, dtype=torch.float32, device=None):
    """L2L masks: positives = identity, negatives = off-diagonal."""
    eye = torch.eye(n, dtype=dtype, device=device)
    return eye, 1.0 - eye


def cross_scale_masks_batched(segment_ids: torch.Tensor, num_graphs: int,
                              node_mask: Optional[torch.Tensor] = None,
                              dtype=torch.float32):
    """G2L masks for a batched graph: pos[g, n] = (node n is in graph g).
    Padding nodes are neither positive nor negative."""
    gids = torch.arange(num_graphs, device=segment_ids.device)[:, None]
    pos = (segment_ids[None, :] == gids).to(dtype)
    valid = (segment_ids[None, :] < num_graphs).to(dtype)
    if node_mask is not None:
        valid = valid * node_mask.to(dtype)[None, :]
    return pos * valid, (1.0 - pos) * valid


def infonce(anchor, sample, pos_mask, neg_mask, tau: float = 0.2,
            anchor_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Log-softmax over the (pos|neg)-masked similarity row, averaged over
    positives, then over (valid) anchors."""
    sim = cosine_similarity_matrix(anchor, sample) / tau
    masked = torch.where(pos_mask + neg_mask > 0, sim,
                         torch.full_like(sim, -1e30))
    log_prob = sim - torch.logsumexp(masked, 1, keepdim=True)
    pos_cnt = torch.clamp(pos_mask.sum(1), min=1.0)
    loss = (log_prob * pos_mask).sum(1) / pos_cnt
    if anchor_mask is not None:
        m = anchor_mask.to(loss.dtype)
        return -(loss * m).sum() / torch.clamp(m.sum(), min=1.0)
    return -loss.mean()


def infonce_batched(anchor, sample, tau: float = 0.2,
                    block_size: int = 1024,
                    anchor_mask: Optional[torch.Tensor] = None):
    """Anchor-row-blocked InfoNCE for the identity-positive case: peak
    memory O(block x N). The same function as the fused kernel's plain
    version."""
    return infonce_fused_plain(anchor, sample, tau=tau,
                               anchor_mask=anchor_mask,
                               block_size=block_size)


def jsd(anchor, sample, pos_mask, neg_mask) -> torch.Tensor:
    """Jensen-Shannon MI estimator with the raw dot product as the
    discriminator. The similarity is multiplied by the masks before the
    softplus, as in the JAX package and its reference: kept for parity."""
    log2 = math.log(2.0)
    sim = anchor @ sample.T
    num_pos = torch.clamp(pos_mask.sum(), min=1.0)
    num_neg = torch.clamp(neg_mask.sum(), min=1.0)
    e_pos = (log2 - F.softplus(-sim * pos_mask)).sum() / num_pos
    neg_sim = sim * neg_mask
    e_neg = (F.softplus(-neg_sim) + neg_sim - log2).sum() / num_neg
    return e_neg - e_pos


def bootstrap_latent(anchor, sample, pos_mask) -> torch.Tensor:
    """Negative mean masked cosine similarity (the negative-free BGRL
    objective), over the anchors that have a positive."""
    sim = cosine_similarity_matrix(anchor, sample)
    cnt = pos_mask.sum(1)
    loss = (sim * pos_mask).sum(1) / torch.clamp(cnt, min=1.0)
    valid = (cnt > 0).to(sim.dtype)
    return -(loss * valid).sum() / torch.clamp(valid.sum(), min=1.0)


class DualBranchContrast:
    """Two-directional contrast: 0.5 (l(a1, s2) + l(a2, s1)).

    mode: "L2L" (node-node, on h1 and h2), "G2G" (graph-graph, on g1 and
    g2), "G2L" (graph-node: with `segment_ids`, graph embeddings against
    the nodes of a batched graph; without, one graph's summary against its
    nodes h1/h2 as positives and the corrupted nodes h3/h4 as negatives).
    loss: "infonce" | "infonce_batched" | "infonce_fused" | "auto" | "jsd"
    | "bootstrap". The identity-positive losses ("infonce_batched",
    "infonce_fused", and "auto", which takes the fused kernels for CUDA
    tensors and "infonce_batched" for CPU tensors) exist for L2L only.
    With those, `node_mask` masks the anchors, not the columns; the
    mask-based losses mask both, as in the JAX package. "infonce_fused"
    takes both directions at once (`infonce_fused_pair`).
    """

    def __init__(self, loss: str = "infonce", mode: str = "L2L",
                 tau: float = 0.2, block_size: int = 1024):
        if loss not in _LOSSES:
            raise ValueError(f"loss must be one of {_LOSSES}, got {loss!r}")
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        if mode != "L2L" and loss in _IDENTITY_LOSSES:
            raise ValueError(f"loss {loss!r} has identity positives and "
                             f"exists for mode L2L only, got {mode!r}")
        self.loss_name = loss
        self.mode = mode
        self.tau = tau
        self.block_size = block_size

    def _identity(self, h1, h2, node_mask):
        """0.5 (l(h1, h2) + l(h2, h1)) of an identity-positive loss."""
        name = self.loss_name
        if name == "auto":
            name = "infonce_fused" if h1.is_cuda else "infonce_batched"
        if name == "infonce_fused":
            return infonce_fused_pair(h1, h2, tau=self.tau,
                                      anchor_mask=node_mask)
        l12, l21 = (infonce_batched(x, y, tau=self.tau,
                                    block_size=self.block_size,
                                    anchor_mask=node_mask)
                    for x, y in ((h1, h2), (h2, h1)))
        return 0.5 * (l12 + l21)

    def _one_way(self, anchor, sample, pos_mask, neg_mask, anchor_mask):
        if self.loss_name == "infonce":
            return infonce(anchor, sample, pos_mask, neg_mask, tau=self.tau,
                           anchor_mask=anchor_mask)
        if self.loss_name == "jsd":
            return jsd(anchor, sample, pos_mask, neg_mask)
        return bootstrap_latent(anchor, sample, pos_mask)

    def __call__(self, h1=None, h2=None, g1=None, g2=None, segment_ids=None,
                 num_graphs: Optional[int] = None, h3=None, h4=None,
                 node_mask=None) -> torch.Tensor:
        if self.mode == "L2L":
            if self.loss_name in _IDENTITY_LOSSES:
                return self._identity(h1, h2, node_mask)
            pos, neg = same_scale_masks(h1.shape[0], h1.dtype, h1.device)
            if node_mask is not None:
                v = node_mask.to(h1.dtype)
                pos = pos * v[None, :] * v[:, None]
                neg = neg * v[None, :] * v[:, None]
            l1 = self._one_way(h1, h2, pos, neg, node_mask)
            l2 = self._one_way(h2, h1, pos, neg, node_mask)
        elif self.mode == "G2G":
            pos, neg = same_scale_masks(g1.shape[0], g1.dtype, g1.device)
            l1 = self._one_way(g1, g2, pos, neg, None)
            l2 = self._one_way(g2, g1, pos, neg, None)
        elif segment_ids is not None:
            pos, neg = cross_scale_masks_batched(
                segment_ids, num_graphs or g1.shape[0], node_mask=node_mask,
                dtype=g1.dtype)
            l1 = self._one_way(g1, h2, pos, neg, None)
            l2 = self._one_way(g2, h1, pos, neg, None)
        else:
            n = h2.shape[0]
            ones = torch.ones((1, n), dtype=g1.dtype, device=g1.device)
            if node_mask is not None:
                ones = ones * node_mask.to(g1.dtype)[None, :]
            zeros = torch.zeros_like(ones)
            pos = torch.cat([ones, zeros], 1)
            neg = torch.cat([zeros, ones], 1)
            l1 = self._one_way(g1, torch.cat([h2, h4], 0), pos, neg, None)
            l2 = self._one_way(g2, torch.cat([h1, h3], 0), pos, neg, None)
        return 0.5 * (l1 + l2)
