"""Tensor parallelism for the encoders: the output dimension of their
dense layers sharded over a mesh axis (counterpart of
`rlap_tpu/parallel/tp.py`).

The JAX package annotates each dense kernel's output dimension and lets
GSPMD partition the matmuls. Here each such `nn.Linear` becomes a
column-parallel layer (`torch.distributed.tensor.parallel.ColwiseParallel`):
its weight [out, in] and bias are `DTensor`s sharded along the output
dimension, the input is taken as replicated, and the output is gathered
back to a replicated plain tensor, so the module around it does not
change.
"""

from __future__ import annotations

from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate
from torch.distributed.tensor.parallel import ColwiseParallel, parallelize_module


def shard_params_tp(module: nn.Module, mesh: DeviceMesh,
                    axis: str = "model") -> nn.Module:
    """Shard, in place, the output dimension of every `nn.Linear` of
    `module` whose `out_features` the axis size divides; every other
    parameter stays replicated. Returns the module."""
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    plan = {name: ColwiseParallel(output_layouts=Replicate())
            for name, m in module.named_modules()
            if isinstance(m, nn.Linear) and m.out_features % size == 0}
    return parallelize_module(module, mesh[axis], plan)
