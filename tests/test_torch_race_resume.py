"""The `race` sampler of the port's rLap, checkpoint and resume, and the
device rule of keys.

The race sampler is held by the structural tests of
`tests/test_torch_rlap.py` and by the spectral-expectation bands of
`tests/test_spectral_parity.py` (BA(100, 3), mean of 8 seeds: largest
singular value within 25%, edge count and total weight within 30%)
against the JAX kernel run with `sampler="race"`. Resume follows the
kill-and-resume tests of `tests/test_recipes.py`: the resumed run gives
the losses of the uninterrupted one (rtol 1e-6: same machine, same
arithmetic)."""

import jax
import numpy as np
import pytest
import torch

from rlap_tpu.core import graph as JG
from rlap_tpu.data.synthetic import barabasi_albert as j_ba
from rlap_tpu.ops.rlap import eliminate as j_eliminate
from rlap_tpu_torch.augment.base import Compose
from rlap_tpu_torch.augment.feature import FeatureMasking
from rlap_tpu_torch.augment.rlap import RLap
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.data.synthetic import (barabasi_albert,
                                           synthetic_node_dataset)
from rlap_tpu_torch.models.grace import GraceTrainer
from rlap_tpu_torch.ops.rlap import (_suffix_winner, approximate_cholesky,
                                     eliminate, eliminate_pair)
from rlap_tpu_torch.utils.checkpoint import (latest_step, restore_checkpoint,
                                             save_checkpoint)


def _key(seed):
    return rng.key(seed, device="cpu")


def _dense(g):
    return G.to_dense(g).numpy()


# ---------------------------------------------------------------------------
# the race sampler
# ---------------------------------------------------------------------------

def test_suffix_winner_is_the_columns_running_argmin():
    rs = np.random.default_rng(0)
    col = np.sort(rs.integers(0, 12, 200))
    race = rs.exponential(size=200)
    got = _suffix_winner(torch.tensor(race), torch.tensor(col)).numpy()
    for k in range(200):
        later = [j for j in range(k, 200) if col[j] == col[k]]
        assert got[k] == min(later, key=lambda j: race[j])


@pytest.mark.parametrize("o_v", ["random", "degree", "coarsen"])
@pytest.mark.parametrize("o_n", ["asc", "random"])
def test_race_output_symmetric_and_sized(o_v, o_n):
    g = barabasi_albert(100, 3, seed=7, device="cpu")
    out = approximate_cholesky(g, _key(0), 50, o_v=o_v, o_n=o_n,
                               device="cpu", sampler="race")
    d = _dense(out)
    np.testing.assert_allclose(d, d.T, atol=1e-5)
    assert ((d > 0).sum(1) == 0).sum() == 50  # BA is connected
    assert bool((out.weights[out.edge_mask] > 0).all())
    assert out.edge_capacity == g.edge_capacity


def test_race_single_elimination_exact_weights():
    """Star 0-(1,2,3) with weights 3, 2, 1, centre eliminated in asc order:
    the weights v_j S_j / csum do not depend on the sampler."""
    g = G.Graph.from_edges([0, 0, 0, 1, 2, 3], [1, 2, 3, 0, 0, 0], 4,
                           weights=[3.0, 2.0, 1.0, 3.0, 2.0, 1.0],
                           device="cpu")
    seen = 0
    for seed in range(20):
        d = _dense(approximate_cholesky(g, _key(seed), 1, o_n="asc",
                                        device="cpu", sampler="race"))
        if d[0].sum() != 0:
            continue  # a leaf was eliminated instead
        seen += 1
        np.testing.assert_allclose(sorted(set(np.round(d[d > 0], 5))),
                                   [np.round(5 / 6, 5), 1.0])
    assert seen > 0


def test_race_partner_comes_from_the_suffix():
    """A path 1-0-2 with the centre eliminated has one possible clique
    edge, (1, 2), whatever the draw."""
    g = G.Graph.from_edges([0, 0, 1, 2], [1, 2, 0, 0], 3, device="cpu")
    hits = 0
    for seed in range(10):
        d = _dense(approximate_cholesky(g, _key(seed), 1, device="cpu",
                                        sampler="race"))
        if d[0].sum() == 0:
            hits += 1
            assert d[1, 2] == d[2, 1] == 0.5
    assert hits > 0


def test_race_eliminate_pair_equals_two_singles():
    g = barabasi_albert(300, 4, seed=4, device="cpu")
    key = _key(9)
    views = eliminate_pair(g, key, 120, o_n="asc", sampler="race")
    for (gp, rm, rounds), kv in zip(views, rng.split(key)):
        ref, rmr, rr = eliminate(g, kv, 120, o_n="asc", sampler="race")
        assert rm == rmr == 120 and rounds == rr
        assert torch.equal(gp.senders, ref.senders)
        assert torch.equal(gp.weights, ref.weights)
    ind, _, _ = eliminate(g, rng.split(key)[0], 120, o_n="asc")
    assert not torch.equal(views[0][0].weights, ind.weights)


def test_rejects_unknown_sampler():
    g = barabasi_albert(20, 2, seed=0, device="cpu")
    for fn in (lambda: eliminate(g, _key(0), 5, sampler="x"),
               lambda: eliminate_pair(g, _key(0), 5, sampler="x"),
               lambda: approximate_cholesky(g, _key(0), 5, device="cpu",
                                            sampler="x")):
        with pytest.raises(ValueError):
            fn()


N, RUNS = 100, 8


def _stats(d):
    return np.linalg.svd(d, compute_uv=False)[0], (d > 0).sum(), d.sum()


@pytest.mark.parametrize("o_v,o_n", [("random", "random"), ("random", "asc"),
                                     ("degree", "random")])
def test_race_spectral_bands_against_jax_race(o_v, o_n):
    t = N // 2
    jg = j_ba(N, 3, seed=11)
    tg = barabasi_albert(N, 3, seed=11, device="cpu")

    def jax_stats(seed):
        out, _, _ = j_eliminate(jg, jax.random.PRNGKey(seed), t, o_v=o_v,
                                o_n=o_n, sampler="race")
        return _stats(np.asarray(JG.to_dense(out)))

    def port_stats(seed):
        return _stats(_dense(approximate_cholesky(
            tg, _key(seed), t, o_v=o_v, o_n=o_n, device="cpu",
            sampler="race")))

    j_sv, j_edges, j_wt = np.mean([jax_stats(s) for s in range(RUNS)], 0)
    p_sv, p_edges, p_wt = np.mean([port_stats(s) for s in range(RUNS)], 0)
    assert abs(p_sv - j_sv) / j_sv < 0.25, (p_sv, j_sv)
    assert abs(p_edges - j_edges) / j_edges < 0.30, (p_edges, j_edges)
    assert abs(p_wt - j_wt) / j_wt < 0.30, (p_wt, j_wt)


# ---------------------------------------------------------------------------
# keys live where the graph lives
# ---------------------------------------------------------------------------

def test_key_and_graph_with_one_device_go_through_rlap():
    """`rng.key(seed, device=d)` and a graph made with the same `device=d`
    meet in `approximate_cholesky` and `RLap`, and the children of a key
    stay on its device."""
    g, _ = synthetic_node_dataset(n=64, feature_dim=8, device="cpu")
    key = rng.key(0, device="cpu")
    assert key.device.type == "cpu"
    assert all(k.device == key.device
               for k in rng.split(key) + [rng.fold_in(key, 3)])
    out = approximate_cholesky(g, key, 20, device="cpu")
    assert out.device.type == "cpu"
    assert int((G.degrees(out) == 0).sum()) >= 20
    view = RLap(0.25, device="cpu")(g, rng.key(1, device="cpu"))
    assert view.device.type == "cpu" and view.x is g.x


def test_key_defaults_to_the_card():
    if torch.cuda.is_available():
        assert rng.key(0).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            rng.key(0)


# ---------------------------------------------------------------------------
# checkpoint and resume
# ---------------------------------------------------------------------------

def test_checkpoint_files_roundtrip(tmp_path):
    ck = str(tmp_path / "ck")
    assert latest_step(ck) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(ck)
    state = {"w": torch.arange(6.0).reshape(2, 3), "epoch": 3,
             "best": float("inf"), "nested": {"flag": True, "l": [1, 2]}}
    save_checkpoint(ck, state, step=3)
    save_checkpoint(ck, {**state, "epoch": 10}, step=10)
    assert latest_step(ck) == 10
    assert restore_checkpoint(ck)["epoch"] == 10
    got = restore_checkpoint(ck, step=3)
    assert got["epoch"] == 3 and got["best"] == float("inf")
    assert got["nested"] == {"flag": True, "l": [1, 2]}
    assert torch.equal(got["w"], state["w"])
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "ckpt_10.pt", "ckpt_3.pt"]  # no temporary file is left


def _trainer(seed):
    return GraceTrainer(Compose([RLap(0.2, device="cpu"),
                                 FeatureMasking(0.3)]),
                        Compose([RLap(0.3, device="cpu"),
                                 FeatureMasking(0.2)]),
                        hidden_dim=16, num_layers=2, seed=seed, device="cpu")


@pytest.fixture(scope="module")
def node_graph():
    return synthetic_node_dataset(n=96, feature_dim=12, device="cpu")[0]


def test_grace_checkpoint_resume(node_graph, tmp_path):
    """Train 4 epochs, 'die', resume to 10: the losses and the parameters
    of the uninterrupted 10-epoch run. The checkpoint carries parameters,
    optimizer state, the key and the early-stop state, so the augmentation
    stream goes on where it stopped."""
    ref = _trainer(7)
    ref_losses = ref.fit(node_graph, max_epochs=10, tolerance=50)
    ck = str(tmp_path / "ck")
    part = _trainer(7).fit(node_graph, max_epochs=4, tolerance=50,
                           checkpoint_dir=ck, checkpoint_every=2)
    assert latest_step(ck) == 3
    t2 = _trainer(7)  # a fresh process's stand-in
    rest = t2.fit(node_graph, max_epochs=10, tolerance=50,
                  checkpoint_dir=ck, checkpoint_every=2)
    assert len(part) == 4 and len(rest) == 6
    np.testing.assert_allclose(part + rest, ref_losses, rtol=1e-6)
    for (name, a), (_, b) in zip(ref.model.state_dict().items(),
                                 t2.model.state_dict().items()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=name)
    assert t2.key.initial_seed() == ref.key.initial_seed()


def test_grace_checkpoint_resume_after_stop(node_graph, tmp_path):
    """A checkpoint whose run has stopped early is not trained further:
    fit returns [] and the model is the stopped run's."""
    ck = str(tmp_path / "ck")
    t1 = _trainer(3)
    part = t1.fit(node_graph, max_epochs=50, tolerance=1, checkpoint_dir=ck,
                  checkpoint_every=1000)
    assert len(part) < 50
    assert restore_checkpoint(ck)["stopped"] is True
    t2 = _trainer(3)
    assert t2.fit(node_graph, max_epochs=50, tolerance=1, checkpoint_dir=ck,
                  checkpoint_every=1000) == []
    for a, b in zip(t1.model.state_dict().values(),
                    t2.model.state_dict().values()):
        assert torch.equal(a, b)


def test_fit_without_checkpoint_dir_writes_nothing(node_graph, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    losses = _trainer(1).fit(node_graph, max_epochs=3, tolerance=50)
    assert len(losses) == 3 and list(tmp_path.iterdir()) == []
