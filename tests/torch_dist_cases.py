"""The rank side of the port's sharded tests: what each spawned rank runs.

`tests/test_torch_parallel.py`, `test_torch_rlap_dist.py` and
`test_torch_mesh_recipes.py` each spawn their ranks once
(`rlap_tpu_torch.parallel.launch`), on the CPU over gloo, with one of the
functions below and the inputs the test made; every case runs in that one
launch and returns its arrays, which the tests then hold against the JAX
package in the pytest process. The spawned ranks import this module, so
it imports no JAX and nothing of `rlap_tpu`.
"""

from __future__ import annotations

import numpy as np
import torch

from rlap_tpu_torch.core import rng
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.ops.spmm import spmm
from rlap_tpu_torch.parallel.mesh import (axis_rank, graph_shardings,
                                          init_distributed, make_mesh,
                                          make_mesh_2level, shard_graph)
from rlap_tpu_torch.parallel.partition import partition_edges_by_sender


def graph_of(arrays: dict) -> Graph:
    """A CPU graph from the numpy arrays a test passed."""
    g = Graph(senders=torch.tensor(arrays["senders"], dtype=torch.int64),
              receivers=torch.tensor(arrays["receivers"], dtype=torch.int64),
              weights=torch.tensor(arrays["weights"]),
              num_nodes=int(arrays["num_nodes"]))
    if arrays.get("x") is not None:
        g = g.replace(x=torch.tensor(arrays["x"]))
    return g


def edges_of(g: Graph) -> dict:
    """A shard's live edges."""
    m = g.edge_mask
    return {"s": g.senders[m], "r": g.receivers[m], "w": g.weights[m]}


def placements(ps) -> list:
    """(kind, dim) of each DTensor placement."""
    return [[type(p).__name__, getattr(p, "dim", None)] for p in ps]


def spmm_grads(g: Graph, x: np.ndarray, w: np.ndarray, b: np.ndarray,
               c: np.ndarray, mesh=None) -> dict:
    """The gradients of sum(spmm(g, Linear(x)) * c) w.r.t. x and the
    Linear's weight and bias, and the output."""
    xx = torch.tensor(x, requires_grad=True)
    lin = torch.nn.Linear(w.shape[1], w.shape[0])
    with torch.no_grad():
        lin.weight.copy_(torch.as_tensor(w))
        lin.bias.copy_(torch.as_tensor(b))
    out = spmm(g, lin(xx), mesh=mesh)
    (out * torch.as_tensor(c)).sum().backward()
    return {"out": out.detach(), "x": xx.grad, "weight": lin.weight.grad,
            "bias": lin.bias.grad}


def parallel_cases(rank: int, world: int, inp: dict) -> dict:
    """Meshes, the sharded SpMM and its gradients, tensor parallelism."""
    from torch.distributed.tensor import DTensor

    from rlap_tpu_torch.models.grace import GRACE
    from rlap_tpu_torch.parallel.tp import shard_params_tp

    out = {"world": init_distributed("cpu")}
    mesh4 = make_mesh(device="cpu")
    mesh22 = make_mesh_2level(2, 2, device="cpu")
    out["mesh22"] = {"names": list(mesh22.mesh_dim_names),
                     "shape": list(mesh22.shape),
                     "data": list(axis_rank(mesh22, "data")),
                     "replica": list(axis_rank(mesh22, "replica"))}
    sh = graph_shardings(mesh22, "data")
    out["shardings"] = {"edge": placements(sh.senders),
                        "node": placements(sh.x)}

    g = graph_of(inp["graph"])
    x = torch.as_tensor(inp["x"])
    for label, mesh in (("w4", mesh4), ("w2", mesh22)):
        size = axis_rank(mesh, "data")[1]
        for split, gg in (("sender", partition_edges_by_sender(g, size)),
                          ("even", g)):
            gs = shard_graph(gg, mesh)
            out[f"spmm_{split}_{label}"] = spmm(gs, x, mesh=mesh)
            out[f"grads_{split}_{label}"] = spmm_grads(
                gs, inp["x"], inp["w"], inp["b"], inp["c"], mesh=mesh)

    tp_mesh = make_mesh_2level(2, 2, axis_names=("replica", "model"),
                               device="cpu")
    tg = graph_of(inp["tp_graph"])
    model = GRACE(tg.x.shape[1], 64, 2, 64,
                  generator=rng.key(3, device="cpu"))
    with torch.no_grad():
        ref = model(tg, tg)
        shard_params_tp(model, tp_mesh, axis="model")
        got = model(tg, tg)
    out["tp"] = {"ref": list(ref), "got": list(got), "linears": {
        name: {"out": m.out_features,
               "placements": placements(m.weight.placements)
               if isinstance(m.weight, DTensor) else None,
               "local": list(m.weight.to_local().shape)
               if isinstance(m.weight, DTensor) else None}
        for name, m in model.named_modules()
        if isinstance(m, torch.nn.Linear)}}
    return out


def rlap_dist_cases(rank: int, world: int, inp: dict) -> dict:
    """`eliminate_sharded`: each rank's shard of each output."""
    from rlap_tpu_torch.parallel.rlap_dist import eliminate_sharded

    mesh = make_mesh(device="cpu")
    out = {}
    for case, spec in inp.items():
        gs = shard_graph(partition_edges_by_sender(
            graph_of(spec["graph"]), world), mesh)
        runs = []
        for o_v, o_n, seed in spec["runs"]:
            res, removed, overflow = eliminate_sharded(
                gs, rng.key(seed, device="cpu"), spec["t"], mesh, o_v=o_v,
                o_n=o_n, slack=spec.get("slack", 2))
            runs.append({"removed": removed, "overflow": overflow,
                         **edges_of(res)})
        out[case] = runs
    return out


def mesh_recipe_cases(rank: int, world: int, inp: dict) -> dict:
    """GRACE and GraphCL with `mesh=`: training, and their sharded
    encoders' forwards."""
    from rlap_tpu_torch.augment.feature import FeatureMasking
    from rlap_tpu_torch.data.synthetic import synthetic_graph_dataset
    from rlap_tpu_torch.models.grace import GRACE, GraceTrainer
    from rlap_tpu_torch.models.graphcl import GraphCLTrainer
    from rlap_tpu_torch.nn.gin import GINEncoder

    mesh = make_mesh(device="cpu")
    out = {}
    g = graph_of(inp["grace_graph"])
    aug = FeatureMasking(pf=0.3)
    tr = GraceTrainer(aug, aug, mesh=mesh, device="cpu", **inp["grace_kw"])
    out["grace_losses"] = [tr.train_epoch(g) for _ in range(3)]
    out["grace_params"] = {k: v.detach().clone()
                           for k, v in tr.model.state_dict().items()}

    model = GRACE(g.x.shape[1], 32, 2, 32, mesh=mesh)
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in inp["flax_state"].items()})
    with torch.no_grad():
        gs = shard_graph(g, mesh)
        out["grace_forward"] = list(model(gs, gs))

    graphs, y = synthetic_graph_dataset(num_graphs=24, seed=3, device="cpu")
    tr = GraphCLTrainer(aug, aug, hidden_dim=16, num_layers=2, batch_size=8,
                        mesh=mesh, seed=0, device="cpu")
    out["graphcl_losses"] = tr.fit(graphs, max_epochs=2)
    out["graphcl_accuracy"] = tr.evaluate(graphs, y)["accuracy"]
    batch, seg, ng = tr.make_batches(graphs)[0]
    gins = [GINEncoder(batch.x.shape[1], 16, 2,
                       generator=rng.key(4, device="cpu"), mesh=m)
            for m in (mesh, None)]
    with torch.no_grad():
        out["gin_sharded"] = list(gins[0](shard_graph(batch, mesh), batch.x,
                                          seg, ng))
        out["gin_local"] = list(gins[1](batch, batch.x, seg, ng))
    return out
