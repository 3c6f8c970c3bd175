"""Edge-partitioned SpMM over a mesh axis (counterpart of
`rlap_tpu/parallel/spmm.py`).

Each rank sums its own edges into a full-width [n, F] partial, and one
`all_reduce` over the axis combines the partials. The node features are
replicated, on the way in and on the way out.

`dist.all_reduce` has no autograd, and `torch.distributed.nn.functional.
all_reduce` all-reduces the gradient too, which multiplies it by the axis
size when everything downstream is replicated. What `shard_map` does with
a replicated input and a replicated output is this pair of functions:
the output is all-reduced forward and passed through backward (every rank
already holds the full gradient of a replicated value), and the
replicated input is passed through forward and its gradient, which each
rank has only for its own edges, all-reduced backward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.ops.spmm import spmm


class _SumPartials(torch.autograd.Function):
    """Forward: all-reduce of the ranks' partials. Backward: identity."""

    @staticmethod
    def forward(ctx, part, group):
        out = part.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Replicated(torch.autograd.Function):
    """Forward: identity. Backward: all-reduce of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def spmm_edge_partitioned(g: Graph, x: torch.Tensor, mesh: DeviceMesh,
                          axis: str = "data",
                          edge_weights: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """out[i] = sum over the edges (j -> i) of every rank of w_e x[j].
    `g` is this rank's shard (its slice of the edges, the global
    `num_nodes`); `x` and the result are replicated."""
    group = mesh.get_group(axis)
    part = spmm(g, _Replicated.apply(x, group), edge_weights=edge_weights)
    return _SumPartials.apply(part, group)
