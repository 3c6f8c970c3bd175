"""Device meshes and sharded graphs on `torch.distributed` (counterpart of
`rlap_tpu/parallel/mesh.py`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over every rank of
the default process group; an axis is a mesh dimension name, and the
collectives of an axis run in `mesh.get_group(axis)`. One rank drives
one device: NCCL needs a card per rank, gloo takes CPU tensors, and CUDA
tensors too.

A sharded `Graph` on a rank holds that rank's slice of the edge arrays
and the global `num_nodes`; `x` and `node_mask` are replicated. Code that
takes a sharded graph says so.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core.graph import Graph

# the variables torchrun sets for every rank
_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT")


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(shape: Sequence[int], names: Sequence[str], device) -> DeviceMesh:
    world = _world()
    size = 1
    for d in shape:
        size *= d
    if size != world:
        raise ValueError(f"mesh {tuple(shape)} needs {size} ranks, the "
                         f"process group has {world}")
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device=None) -> DeviceMesh:
    """A 1-D mesh over `n_devices` ranks (all of them by default) on the
    card, or on the CPU where `device` says "cpu"."""
    return _mesh((n_devices or _world(),), (axis_name,), device)


def make_mesh_2level(replica: Optional[int] = None,
                     data: Optional[int] = None,
                     axis_names=("replica", "data"),
                     device=None) -> DeviceMesh:
    """A (replica, data) mesh. The outer axis spans hosts and carries the
    gradient averages; the inner one spans the ranks of a host and
    carries the graph collectives. `replica` defaults to the number of
    hosts (world size over torchrun's local world size; 1 on one host),
    `data` to the ranks per replica."""
    world = _world()
    if replica is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        replica = max(1, world // max(1, local))
    if data is None:
        data = world // replica
    return _mesh((replica, data), axis_names, device)


def init_distributed(device=None) -> int:
    """Initialise the default process group when torchrun's variables are
    set and it is not initialised yet: NCCL for the card (one card per
    rank, the rank's `LOCAL_RANK`), gloo where `device` says "cpu".
    Otherwise does nothing. Returns the world size."""
    if (not dist.is_initialized()
            and all(v in os.environ for v in _TORCHRUN_VARS)):
        if resolve_device(device).type == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
            dist.init_process_group("nccl")
        else:
            dist.init_process_group("gloo")
    return _world()


def _placements(mesh: DeviceMesh, axis: str, sharded):
    dim = mesh.mesh_dim_names.index(axis)
    return tuple(sharded if i == dim else Replicate()
                 for i in range(mesh.ndim))


def graph_shardings(mesh: DeviceMesh, axis: str = "data") -> Graph:
    """DTensor placements of a sharded Graph's fields, one per mesh
    dimension: the edge arrays `Shard(0)` along `axis`, the node arrays
    replicated."""
    edge = _placements(mesh, axis, Shard(0))
    node = _placements(mesh, axis, Replicate())
    return Graph(senders=edge, receivers=edge, weights=edge, num_nodes=0,
                 x=node, node_mask=node)


def axis_rank(mesh: DeviceMesh, axis: str = "data") -> tuple:
    """(this rank's index along `axis`, the axis size)."""
    return mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(
        axis))


def shard_graph(g: Graph, mesh: DeviceMesh, axis: str = "data") -> Graph:
    """This rank's slice of a replicated graph's edge arrays: the
    capacity is padded up to a multiple of the axis size and cut into
    equal slices. On a graph arranged by `partition_edges_by_sender`, the
    slice holds exactly the edges of the rank's node block."""
    rank, size = axis_rank(mesh, axis)
    cap = -(-g.edge_capacity // size) * size
    g = G.with_capacity(g, cap)
    lo, hi = rank * cap // size, (rank + 1) * cap // size
    return g.replace(senders=g.senders[lo:hi], receivers=g.receivers[lo:hi],
                     weights=g.weights[lo:hi])


def node_block(num_nodes: int, mesh: DeviceMesh, axis: str = "data"):
    """[lo, hi) of this rank's block of node ids: contiguous equal blocks
    of ceil(n / size), the last one short."""
    rank, size = axis_rank(mesh, axis)
    block = -(-num_nodes // size)
    return min(rank * block, num_nodes), min((rank + 1) * block, num_nodes)


def broadcast_graph(g: Optional[Graph], mesh: DeviceMesh,
                    device=None) -> Graph:
    """`g` as rank 0 of the mesh holds it, on every rank of the mesh (the
    other ranks pass None). A value that must be identical on every rank
    is made once and sent, because two ranks that compute it apart on the
    card can differ: `index_add_` adds floats there in no fixed order."""
    src = int(mesh.mesh.flatten()[0])
    meta = [None]
    if dist.get_rank() == src:
        meta = [(g.edge_capacity, g.num_nodes, g.weights.dtype,
                 None if g.x is None else (tuple(g.x.shape), g.x.dtype),
                 g.node_mask is not None)]
    group = _mesh_group(mesh)
    dist.broadcast_object_list(meta, src=src, group=group)
    cap, n, wdtype, xmeta, has_mask = meta[0]
    dev = resolve_device(device)
    if dist.get_rank() != src:
        g = Graph(senders=torch.empty(cap, dtype=torch.int64, device=dev),
                  receivers=torch.empty(cap, dtype=torch.int64, device=dev),
                  weights=torch.empty(cap, dtype=wdtype, device=dev),
                  num_nodes=n,
                  x=None if xmeta is None else torch.empty(
                      xmeta[0], dtype=xmeta[1], device=dev),
                  node_mask=torch.empty(n, dtype=torch.bool, device=dev)
                  if has_mask else None)
    fields = {}
    for name in ("senders", "receivers", "weights", "x", "node_mask"):
        t = getattr(g, name)
        if t is not None:
            t = t.contiguous()
            dist.broadcast(t, src=src, group=group)
        fields[name] = t
    return g.replace(**fields)


def shard_views(make, mesh: DeviceMesh, device=None, axis: str = "data"):
    """The pair of graphs `make()` returns, made on the mesh's first rank
    only (`broadcast_graph`), as this rank's shard of each along `axis`."""
    first = dist.get_rank() == int(mesh.mesh.flatten()[0])
    views = make() if first else (None, None)
    return tuple(shard_graph(broadcast_graph(v, mesh, device), mesh, axis)
                 for v in views)


def _mesh_group(mesh: DeviceMesh):
    """The process group of every rank of the mesh (a mesh made here
    spans the default group)."""
    return mesh.get_group() if mesh.ndim == 1 else dist.group.WORLD


def average_gradients(params, mesh: DeviceMesh) -> None:
    """Replace each gradient by its mean over the ranks of the mesh, in
    one all-reduce of a flat buffer. Where every rank already holds the
    full gradient of a replicated parameter this changes nothing but the
    last bits, which keeps the ranks' parameters from drifting apart."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([gr.reshape(-1) for gr in grads])
    dist.all_reduce(flat, group=_mesh_group(mesh))
    flat /= mesh.size()
    off = 0
    for gr in grads:
        gr.copy_(flat[off:off + gr.numel()].view_as(gr))
        off += gr.numel()
