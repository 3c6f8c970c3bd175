"""Recipes with sharded encoders, mirroring `tests/test_mesh_recipes.py`:

* GRACE with `mesh=` against the port's local trainer, same seeds and
  `FeatureMasking` views: 3 epochs of losses within rtol 1e-4, atol 1e-5,
  and the parameters equal on every rank;
* the sharded GRACE forward on weights carried from flax (`convert.py`)
  against the JAX `GRACE(mesh=...)` forward (rtol 2e-4, atol 2e-5);
* GraphCL with `mesh=`: 2 epochs with finite losses and a valid probe, and
  its sharded GIN forward equal to the local one (rtol 1e-5, atol 1e-5);
* `rlap_tpu_torch.parallel.dryrun_multichip` at world 2, n=4096, on the
  CPU: the sharded rLap and a GRACE step through it.

Four ranks are spawned once over gloo on the CPU
(`tests/torch_dist_cases.py::mesh_recipe_cases`); the dry run spawns its
own two.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rlap_tpu.data.synthetic import synthetic_node_dataset as j_nodes
from rlap_tpu.models.grace import GRACE as JGRACE
from rlap_tpu_torch.augment.feature import FeatureMasking
from rlap_tpu_torch.convert import flax_to_state_dict
from rlap_tpu_torch.models.grace import GraceTrainer
from rlap_tpu_torch.parallel.dryrun import dryrun_multichip
from rlap_tpu_torch.parallel.launch import launch

import torch_dist_cases as cases

WORLD = 4
GRACE_KW = dict(hidden_dim=32, num_layers=2, lr=1e-3, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    # n and e_cap + n divisible by the JAX mesh (gcn_norm appends loops)
    jg, _ = j_nodes(n=256, feature_dim=64, edge_capacity=4096, seed=0)
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))
    model = JGRACE(hidden_dim=32, num_layers=2, proj_dim=32, mesh=mesh)
    params = model.init(jax.random.PRNGKey(0), jg, jg)["params"]
    jax_forward = [np.asarray(h) for h in model.apply({"params": params},
                                                       jg, jg)]
    graph = {"senders": np.asarray(jg.senders),
             "receivers": np.asarray(jg.receivers),
             "weights": np.asarray(jg.weights), "num_nodes": jg.num_nodes,
             "x": np.asarray(jg.x)}
    inp = {"grace_graph": graph, "grace_kw": GRACE_KW,
           "flax_state": flax_to_state_dict(params)}
    ranks = launch(cases.mesh_recipe_cases, WORLD, args=(inp,), timeout=240)
    return {"graph": graph, "jax_forward": jax_forward, "ranks": ranks}


def test_sharded_grace_matches_the_local_trainer(setup):
    aug = FeatureMasking(pf=0.3)
    local = GraceTrainer(aug, aug, device="cpu", **GRACE_KW)
    g = cases.graph_of(setup["graph"])
    l_local = [local.train_epoch(g) for _ in range(3)]
    for res in setup["ranks"]:
        assert np.all(np.isfinite(res["grace_losses"]))
        np.testing.assert_allclose(res["grace_losses"], l_local, rtol=1e-4,
                                   atol=1e-5)


def test_sharded_grace_parameters_equal_on_every_rank(setup):
    first = setup["ranks"][0]["grace_params"]
    for res in setup["ranks"][1:]:
        for k, v in first.items():
            assert torch.equal(res["grace_params"][k], v), k


def test_sharded_grace_forward_matches_jax_mesh(setup):
    for res in setup["ranks"]:
        for got, ref in zip(res["grace_forward"], setup["jax_forward"]):
            np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4,
                                       atol=2e-5)


def test_sharded_graphcl_trains_and_probes(setup):
    for res in setup["ranks"]:
        losses = res["graphcl_losses"]
        assert len(losses) == 2 and np.all(np.isfinite(losses))
        assert 0.0 <= res["graphcl_accuracy"] <= 1.0
    assert len({tuple(r["graphcl_losses"]) for r in setup["ranks"]}) == 1


def test_sharded_gin_forward_matches_local(setup):
    for res in setup["ranks"]:
        for got, ref in zip(res["gin_sharded"], res["gin_local"]):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_dryrun_multichip_world_2():
    res = dryrun_multichip(2, "gloo", n=4096, device="cpu", timeout=240)
    assert res["world_size"] == 2 and len(res["ranks"]) == 2
    for rank in res["ranks"]:
        assert rank["mesh"] == {"replica": 1, "data": 2}
        assert rank["rlap_n"] == 4096 and rank["n"] == 4096
        assert rank["num_remove"] == int(0.2 * 4096)
        assert len(rank["losses"]) == 1 and np.isfinite(rank["losses"][0])
        assert len(rank["rlap_ms_per_view"]) == 2
