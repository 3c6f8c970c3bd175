"""The port's sharded layer against the JAX package's: the sender-block
partition (array-equal, in one process), the edge-partitioned SpMM at
world 2 and 4 on a sender-partitioned graph and on an even edge split
(rtol 1e-5, atol 1e-5 against `rlap_tpu.parallel.spmm_edge_partitioned`),
its gradients against the local SpMM's (rtol 1e-5, atol 1e-6: a
world-size factor in the backward shows here), the meshes, the DTensor
placements of a sharded graph, and tensor parallelism (the forward
against the replicated one, rtol 2e-4, atol 2e-5).

Four ranks are spawned once, on the CPU over gloo
(`tests/torch_dist_cases.py::parallel_cases`); world 2 is the "data" axis
of a (replica=2, data=2) mesh. The JAX side runs here, on the
8-device CPU mesh of `tests/conftest.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rlap_tpu.data.synthetic import barabasi_albert as j_ba
from rlap_tpu.data.synthetic import synthetic_node_dataset as j_nodes
from rlap_tpu.parallel.partition import \
    partition_edges_by_sender as j_partition
from rlap_tpu.parallel.spmm import spmm_edge_partitioned as j_spmm_dist
from rlap_tpu_torch.data.synthetic import barabasi_albert as t_ba
from rlap_tpu_torch.ops.spmm import spmm
from rlap_tpu_torch.parallel import partition as TP
from rlap_tpu_torch.parallel.launch import launch

import torch_dist_cases as cases

WORLD = 4
N, F, H = 128, 32, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arrays(g) -> dict:
    return {"senders": np.asarray(g.senders), "receivers":
            np.asarray(g.receivers), "weights": np.asarray(g.weights),
            "num_nodes": g.num_nodes,
            "x": None if g.x is None else np.asarray(g.x)}


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.default_rng(0)
    tg, _ = j_nodes(n=128, feature_dim=32, edge_capacity=2048, seed=2)
    return {"graph": arrays(j_ba(N, 4, seed=0, edge_capacity=2048)),
            "x": rs.normal(size=(N, F)).astype(np.float32),
            "w": rs.normal(size=(H, F)).astype(np.float32) / np.sqrt(F),
            "b": rs.normal(size=(H,)).astype(np.float32),
            "c": rs.normal(size=(N, H)).astype(np.float32),
            "tp_graph": arrays(tg)}


@pytest.fixture(scope="module")
def ranks(inputs):
    return launch(cases.parallel_cases, WORLD, args=(inputs,),
                  timeout=240)


def jax_mesh(size):
    return Mesh(np.asarray(jax.devices()[:size]), ("data",))


@pytest.mark.parametrize("num_shards", [2, 4, 8])
def test_partition_edges_by_sender_equals_jax(num_shards):
    jg = j_ba(300, 4, seed=1)
    tg = t_ba(300, 4, seed=1, device="cpu")
    jp, tp = j_partition(jg, num_shards), TP.partition_edges_by_sender(
        tg, num_shards)
    for name in ("senders", "receivers", "weights"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)
    ids = np.arange(301)
    np.testing.assert_array_equal(TP.node_block_owner(ids, 300, num_shards),
                                  np.minimum(ids // -(-300 // num_shards),
                                             num_shards - 1))


@pytest.mark.parametrize("split", ["sender", "even"])
@pytest.mark.parametrize("world", [2, 4])
def test_spmm_edge_partitioned_matches_jax(ranks, inputs, world, split):
    g = inputs["graph"]
    jg = j_ba(N, 4, seed=0, edge_capacity=2048)
    if split == "sender":
        jg = j_partition(jg, world)
    ref = np.asarray(j_spmm_dist(jg, jnp.asarray(inputs["x"]),
                                 jax_mesh(world)))
    assert g["num_nodes"] == N
    for res in ranks:
        np.testing.assert_allclose(res[f"spmm_{split}_w{world}"].numpy(),
                                   ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("split", ["sender", "even"])
@pytest.mark.parametrize("world", [2, 4])
def test_spmm_gradients_match_local(ranks, inputs, world, split):
    local = cases.spmm_grads(cases.graph_of(inputs["graph"]), inputs["x"],
                             inputs["w"], inputs["b"], inputs["c"])
    for res in ranks:
        got = res[f"grads_{split}_w{world}"]
        for name in ("out", "x", "weight", "bias"):
            np.testing.assert_allclose(got[name].numpy(),
                                       local[name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def test_meshes_and_graph_shardings(ranks):
    for rank, res in enumerate(ranks):
        assert res["world"] == WORLD
        mesh = res["mesh22"]
        assert mesh["names"] == ["replica", "data"]
        assert mesh["shape"] == [2, 2]
        assert mesh["data"] == [rank % 2, 2]
        assert mesh["replica"] == [rank // 2, 2]
        assert res["shardings"] == {
            "edge": [["Replicate", None], ["Shard", 0]],
            "node": [["Replicate", None], ["Replicate", None]]}


def test_spmm_over_the_inner_axis_of_a_2x2_mesh(ranks, inputs):
    """The ranks of one replica hold the two halves of the edges; both
    replicas give the local result."""
    ref = spmm(cases.graph_of(inputs["graph"]), torch.as_tensor(inputs["x"]))
    for res in ranks:
        np.testing.assert_allclose(res["spmm_even_w2"].numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_tensor_parallel_forward_matches_replicated(ranks):
    for res in ranks:
        tp = res["tp"]
        for got, ref in zip(tp["got"], tp["ref"]):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4,
                                       atol=2e-5)
        assert tp["linears"]
        for name, lin in tp["linears"].items():
            if lin["out"] % 2 == 0:
                assert lin["placements"] == [["Shard", 0]], name
                assert lin["local"][0] == lin["out"] // 2, name
