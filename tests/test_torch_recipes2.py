"""The port's CCA-SSG, MVGRL, GraphCL and BGRL against the JAX package's,
on the same numpy inputs: the CCA-SSG loss and its gradients (rtol 1e-5),
each model's forward on converted parameters (rtol 1e-5), 3 training
steps on fixed views from converted parameters (losses rtol 1e-4, as
`tests/test_torch_grace.py` holds GRACE), MVGRL's subsample rule on the
JAX package's draws (exact); the port's versions of the `*_learns` bars of
`tests/test_recipes.py`; and kill-and-resume, which gives the
uninterrupted run's losses (rtol 1e-6: same machine, same arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlap_tpu.augment import (EdgeRemoving as JEdgeRemoving,
                              Identity as JIdentity,
                              NodeDropping as JNodeDropping)
from rlap_tpu.core import graph as JG
from rlap_tpu.data.synthetic import (
    synthetic_graph_dataset as j_synthetic_graph_dataset,
    synthetic_node_dataset as j_synthetic_node_dataset)
from rlap_tpu.models.bgrl import BGRL as JBGRL
from rlap_tpu.models.bgrl import BGRLTrainer as JBGRLTrainer
from rlap_tpu.models.cca_ssg import CCASSG as JCCASSG
from rlap_tpu.models.cca_ssg import CCASSGTrainer as JCCASSGTrainer
from rlap_tpu.models.graphcl import GraphCLTrainer as JGraphCLTrainer
from rlap_tpu.models.mvgrl import MVGRLTrainer as JMVGRLTrainer
from rlap_tpu.objectives.cca import cca_ssg_loss as j_cca_ssg_loss
from rlap_tpu_torch.augment.base import Compose, Identity
from rlap_tpu_torch.augment.cca_registry import make_cca_augmentor
from rlap_tpu_torch.augment.edge import EdgeRemoving
from rlap_tpu_torch.augment.feature import FeatureMasking
from rlap_tpu_torch.augment.rlap import RLap
from rlap_tpu_torch.convert import flax_to_state_dict, load_flax_params
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.data.synthetic import (synthetic_graph_dataset,
                                           synthetic_node_dataset)
from rlap_tpu_torch.models.bgrl import BGRLTrainer, dropout
from rlap_tpu_torch.models.cca_ssg import CCASSGTrainer
from rlap_tpu_torch.models.graphcl import GraphCLTrainer
from rlap_tpu_torch.models.mvgrl import MVGRLTrainer, subsample_mask
from rlap_tpu_torch.objectives.cca import cca_ssg_loss

CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of a thread per core in each of them makes every
    small op wait on threads that are not scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_torch(jg) -> G.Graph:
    def t(a, dtype=None):
        return None if a is None else torch.tensor(np.asarray(a),
                                                   dtype=dtype)
    return G.Graph(senders=t(jg.senders, torch.int64),
                   receivers=t(jg.receivers, torch.int64),
                   weights=t(jg.weights), num_nodes=jg.num_nodes,
                   x=t(jg.x), node_mask=t(jg.node_mask))


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else got,
        np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _close_scaled(got, want, rtol=1e-5):
    """rtol, and an atol of rtol times the largest entry: entries near 0
    come out of sums of larger terms (the GIN sums its neighbours
    unnormalised, batch norm divides by the spread), so the order of a
    sum (`index_add` against `segment_sum`) moves them by the rounding of
    the large ones."""
    want = np.asarray(want)
    _close(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


def _node_views(n=96, f=24):
    """A node graph and two fixed views (edge removal, node dropping) from
    the JAX package, with their port twins."""
    jg, _ = j_synthetic_node_dataset(n=n, num_classes=3, feature_dim=f,
                                     seed=2)
    v1 = JEdgeRemoving(0.3)(jg, jax.random.PRNGKey(1))
    v2 = JNodeDropping(0.2)(jg, jax.random.PRNGKey(2))
    return (v1, v2), (to_torch(v1), to_torch(v2))


def _graph_views(num_graphs=12):
    """A padded union of small graphs and two fixed views of it. The
    features are normal draws, not the stand-in's ones: with x = ones
    every node of a degree class has the same embedding, some units are
    near-constant, and batch norm divides rounding noise by variances
    near 1e-6 (there the JAX package's own first BGRL loss moves by 5e-5
    when the edges are listed in another order)."""
    graphs, _ = j_synthetic_graph_dataset(num_graphs=num_graphs, n_lo=6,
                                          n_hi=12, feature_dim=5, seed=1)
    r = np.random.default_rng(4)
    graphs = [g.replace(x=jnp.asarray(r.normal(size=g.x.shape), jnp.float32))
              for g in graphs]
    batch, seg = JG.block_diagonal(graphs, node_capacity=256,
                                   edge_capacity=1024)
    v1 = JEdgeRemoving(0.3)(batch, jax.random.PRNGKey(1))
    v2 = JNodeDropping(0.2)(batch, jax.random.PRNGKey(2))
    return ((v1, v2, seg), (to_torch(v1), to_torch(v2),
                            torch.tensor(np.asarray(seg), dtype=torch.int64)))


# ---------------------------------------------------------------------------
# CCA-SSG loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pre", [False, True])
def test_cca_loss_and_gradients_match_jax(masked, pre):
    r = np.random.default_rng(0)
    z1, z2 = (r.normal(size=(120, 16)).astype(np.float32) for _ in range(2))
    mask = r.random(120) < 0.8 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)

    def jloss(a, b):
        return j_cca_ssg_loss(a, b, lam=2e-3, node_mask=jm,
                              pre_standardized=pre)

    want, (ga, gb) = jax.value_and_grad(jloss, (0, 1))(jnp.asarray(z1),
                                                       jnp.asarray(z2))
    a = torch.tensor(z1, requires_grad=True)
    b = torch.tensor(z2, requires_grad=True)
    got = cca_ssg_loss(a, b, lam=2e-3, node_mask=tm, pre_standardized=pre)
    got.backward()
    _close(got, want, rtol=1e-5, atol=0)
    _close(a.grad, ga)
    _close(b.grad, gb)


# ---------------------------------------------------------------------------
# forwards on converted parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backbone", ["gcn", "mlp"])
def test_cca_ssg_forward_matches_jax(backbone):
    (j1, j2), (t1, t2) = _node_views()
    jm = JCCASSG(32, 16, 2, backbone)
    params = jm.init(jax.random.PRNGKey(0), j1, j2)["params"]
    tr = CCASSGTrainer(lambda g, k: g, hidden_dim=32, out_dim=16,
                       backbone=backbone, **CPU)
    tr.ensure_init(t1)
    load_flax_params(tr.model, params)
    want = jm.apply({"params": params}, j1, j2)
    for got, w in zip(tr.model(t1, t2), want):
        _close(got, w)
    _close(tr.model.embed(t1), jm.apply({"params": params}, j1,
                                        method=JCCASSG.embed))


def test_mvgrl_forward_matches_jax():
    (j1, j2), (t1, t2) = _node_views()
    jt = JMVGRLTrainer(JIdentity(), JIdentity(), hidden_dim=16)
    kc = jax.random.PRNGKey(3)
    params = jt.model.init(jax.random.PRNGKey(0), j1, j2, kc)["params"]
    tr = MVGRLTrainer(Identity(), Identity(), hidden_dim=16, **CPU)
    tr.ensure_init(t1)
    load_flax_params(tr.model, params)
    perms = [torch.tensor(np.asarray(jax.random.permutation(k, j1.num_nodes)))
             for k in jax.random.split(kc)]
    want = jt.model.apply({"params": params}, j1, j2, kc)
    for got, w in zip(tr.model(t1, t2, *perms), want):
        _close(got, w)


@pytest.mark.parametrize("train", [True, False])
def test_graphcl_forward_matches_jax(train):
    (j1, _, seg), (t1, _, tseg) = _graph_views()
    jt = JGraphCLTrainer(None, None, hidden_dim=16, num_layers=3)
    var = jt.model.init(jax.random.PRNGKey(0), j1, seg, 12)
    # running statistics away from their initial values
    bs = jax.tree.map(lambda v: v + 0.1 * jnp.arange(v.shape[0]) / 16,
                      var["batch_stats"])
    tr = GraphCLTrainer(None, None, hidden_dim=16, num_layers=3, **CPU)
    tr.ensure_init([t1])
    load_flax_params(tr.model, var["params"], bs)
    want, new = jt.model.apply({"params": var["params"], "batch_stats": bs},
                               j1, seg, 12, train, mutable=["batch_stats"])
    for got, w in zip(tr.model(t1, tseg, 12, train=train), want):
        _close_scaled(got, w)
    for k, v in flax_to_state_dict({}, new["batch_stats"]).items():
        _close(tr.batch_stats[k], v.numpy(), msg=k)


def test_bgrl_online_and_target_match_jax():
    (j1, _, seg), (t1, _, tseg) = _graph_views()
    jm = JBGRL(16, 2, dropout=0.0)
    var = jm.init(jax.random.PRNGKey(0), j1, seg, 12, True,
                  method=JBGRL.online)
    tr = BGRLTrainer(None, None, hidden_dim=16, **CPU)
    tr.dropout = 0.0
    tr.ensure_init([t1])
    load_flax_params(tr.model, var["params"], var["batch_stats"])
    v = {"params": var["params"], "batch_stats": var["batch_stats"]}
    # the target first: it reads the running statistics that a training
    # pass of the online model moves
    tr.target_params = flax_to_state_dict(var["params"])
    _close_scaled(tr.target_model.target(t1, tseg, 12),
                  jm.apply(v, j1, seg, 12, method=JBGRL.target))
    for train in (False, True):
        want, _ = jm.apply(v, j1, seg, 12, train, method=JBGRL.online,
                           mutable=["batch_stats"])
        for got, w in zip(tr.model(t1, tseg, 12, train=train), want):
            _close_scaled(got, w)


def test_bgrl_dropout_rate():
    x = torch.ones(200, 50)
    out = dropout(x, 0.2, torch.Generator().manual_seed(0))
    assert abs(float((out == 0).float().mean()) - 0.2) < 0.02
    assert bool(((out == 0) | (out == 1.25)).all())
    assert dropout(x, 0.0, None) is x


# ---------------------------------------------------------------------------
# three training steps from converted parameters
# ---------------------------------------------------------------------------

def test_cca_ssg_three_steps_match_jax():
    (j1, j2), (t1, t2) = _node_views()
    j1, j2 = JG.add_self_loops(j1), JG.add_self_loops(j2)
    t1, t2 = G.add_self_loops(t1), G.add_self_loops(t2)
    kw = dict(hidden_dim=32, out_dim=16, lr=5e-3, weight_decay=1e-4,
              lam=2e-3)
    jt = JCCASSGTrainer(None, **kw)
    params = jt.model.init(jax.random.PRNGKey(0), j1, j2)["params"]
    opt = jt.tx.init(params)
    tr = CCASSGTrainer(None, **kw, **CPU)
    tr.ensure_init(t1)
    load_flax_params(tr.model, params)
    for _ in range(3):
        params, opt, jloss = jt._step(params, opt, j1, j2)
        _close(tr.train_step(t1, t2), float(jloss), rtol=1e-4, atol=0)
    # the last layer's bias is not compared: standardisation subtracts it,
    # so its gradient is zero but for rounding, which Adam scales up to
    # steps of the full learning rate in either direction
    for k, v in flax_to_state_dict(params).items():
        if k != "net.convs.1.bias":
            _close(tr.model.state_dict()[k], v.numpy(), rtol=1e-4, msg=k)


def test_mvgrl_three_steps_match_jax():
    (j1, j2), (t1, t2) = _node_views()
    kw = dict(hidden_dim=16, lr=5e-3, weight_decay=1e-4)
    jt = JMVGRLTrainer(None, None, **kw)
    params = jt.model.init(jax.random.PRNGKey(0), j1, j2,
                           jax.random.PRNGKey(1))["params"]
    opt = jt.tx.init(params)
    tr = MVGRLTrainer(None, None, **kw, **CPU)
    tr.ensure_init(t1)
    load_flax_params(tr.model, params)
    for step in range(3):
        kc = jax.random.PRNGKey(10 + step)
        perms = [torch.tensor(np.asarray(jax.random.permutation(
            k, j1.num_nodes))) for k in jax.random.split(kc)]
        params, opt, jloss = jt._step(params, opt, j1, j2, kc)
        _close(tr.train_step(t1, t2, *perms), float(jloss), rtol=1e-4, atol=0)


def test_graphcl_three_steps_match_jax():
    (j1, j2, seg), (t1, t2, tseg) = _graph_views()
    kw = dict(hidden_dim=16, lr=1e-2, weight_decay=1e-4)
    jt = JGraphCLTrainer(None, None, **kw)
    var = jt.model.init(jax.random.PRNGKey(0), j1, seg, 12)
    params, bs = var["params"], var["batch_stats"]
    opt = jt.tx.init(params)
    tr = GraphCLTrainer(None, None, **kw, **CPU)
    tr.ensure_init([t1])
    load_flax_params(tr.model, params, bs)
    for _ in range(3):
        params, bs, opt, jloss = jt._step(params, bs, opt, j1, j2, seg, 12)
        _close(tr.train_step(t1, t2, tseg, 12), float(jloss), rtol=1e-4,
               atol=0)


def test_bgrl_three_steps_match_jax():
    """Dropout 0 on both sides (the masks come from different
    generators). At lr 1e-3: the biases in front of a batch norm have a
    gradient that is zero but for rounding, which Adam scales up to steps
    of the full learning rate, and the target (an EMA read with running
    statistics) sees them; at lr 1e-2 the JAX package's own third loss
    moves by 2e-4 when the edges are listed in another order."""
    (j1, j2, seg), (t1, t2, tseg) = _graph_views()
    kw = dict(hidden_dim=16, lr=1e-3, weight_decay=1e-4)
    jt = JBGRLTrainer(None, None, **kw)
    jt.model = JBGRL(16, 2, dropout=0.0)
    var = jt.model.init(jax.random.PRNGKey(0), j1, seg, 12, True,
                        method=JBGRL.online)
    params, bs = var["params"], var["batch_stats"]
    target = jax.tree.map(jnp.copy, params)
    opt = jt.tx.init(params)
    tr = BGRLTrainer(None, None, **kw, **CPU)
    tr.dropout = 0.0
    tr.ensure_init([t1])
    load_flax_params(tr.model, params, bs)
    tr.target_params = flax_to_state_dict(target)
    for step in range(3):
        params, target, bs, opt, jloss = jt._step(
            params, target, bs, opt, j1, j2, seg, 12,
            jax.random.PRNGKey(step))
        got = tr.train_step(t1, t2, tseg, 12,
                            torch.Generator().manual_seed(step))
        _close(got, float(jloss), rtol=1e-4, atol=0)


def test_mvgrl_subsample_on_jax_draws():
    """Diffusion views of a graph over `subsample` nodes are cut to the
    nodes whose uniform reaches the subsample-th largest score: the JAX
    trainer's views, given its keys, against the port's rule on the same
    uniforms."""
    jg, _ = j_synthetic_node_dataset(n=128, num_classes=3, feature_dim=8,
                                     seed=1)
    jg = JNodeDropping(0.3)(jg, jax.random.PRNGKey(0))  # isolated nodes
    jt = JMVGRLTrainer(JIdentity(), JIdentity(),
                       augmentor_name="PPRDiffusion", subsample=40)
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    j1, j2 = jt._views(jg, keys=keys)
    u = torch.tensor(np.asarray(jax.random.uniform(keys[2], (128,))))
    tg = to_torch(jg)
    keep = subsample_mask(tg, u, 40)
    assert int(keep.sum()) >= 40
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j2.node_mask))
    np.testing.assert_array_equal(G.induced_subgraph(tg, keep).senders,
                                  np.asarray(j1.senders))
    # ties at the threshold are all kept
    tied = torch.full((128,), 0.5)
    assert int(subsample_mask(tg, tied, 40).sum()) == int(
        (G.degrees(tg) > 0).sum())


def test_mvgrl_views_subsample_and_embed_pinned():
    g, _ = synthetic_node_dataset(n=128, feature_dim=8, seed=1, **CPU)
    a1 = Compose([Identity(), FeatureMasking(0.3)])
    tr = MVGRLTrainer(a1, Identity(), augmentor_name="MarkovDiffusion",
                      hidden_dim=8, subsample=50, **CPU)
    g1, g2 = tr.views(g)
    assert int(g1.node_mask.sum()) >= 50
    assert bool(torch.equal(g1.node_mask, g2.node_mask))
    dead = ~g1.node_mask
    assert not bool(torch.isin(g1.senders[g1.edge_mask],
                               torch.nonzero(dead)[:, 0]).any())
    tr.fit(g, max_epochs=2, tolerance=5)
    seed = tr.key.initial_seed()
    assert torch.equal(tr.embed(g), tr.embed(g))
    assert tr.key.initial_seed() == seed


# ---------------------------------------------------------------------------
# the learning bars of tests/test_recipes.py, on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def node_data():
    return synthetic_node_dataset(n=128, num_classes=4, feature_dim=32,
                                  p_in=0.15, p_out=0.01, seed=0, **CPU)


@pytest.fixture(scope="module")
def graph_data():
    return synthetic_graph_dataset(num_graphs=48, n_lo=8, n_hi=16,
                                   feature_dim=8, seed=0, **CPU)


def _views(first):
    return (Compose([first, FeatureMasking(0.3)]),
            Compose([RLap(0.2, device="cpu"), FeatureMasking(0.3)]))


def test_mvgrl_learns(node_data):
    g, y = node_data
    tr = MVGRLTrainer(*_views(Identity()), augmentor_name="rLap",
                      hidden_dim=32, lr=5e-3, seed=0, **CPU)
    losses = tr.fit(g, max_epochs=25, tolerance=25)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    majority = np.max(np.bincount(y)) / len(y)
    assert tr.evaluate(g, y)["accuracy"] > max(0.35, majority + 0.05)


def test_cca_ssg_learns(node_data):
    g, y = node_data
    tr = CCASSGTrainer(make_cca_augmentor("rlap", 0.2, 0.2), hidden_dim=64,
                       out_dim=64, lr=1e-3, lam=1e-3, seed=0, **CPU)
    losses = tr.fit(g, max_epochs=25)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert tr.evaluate(g, y)["accuracy"] > 0.4


@pytest.mark.parametrize("name, cls", [("markovd", "MarkovDiffusion"),
                                       ("pprd", "PPRDiffusion")])
def test_cca_ssg_builds_a_diffusion_once_per_graph(name, cls, node_data,
                                                   monkeypatch):
    """The trainer hands its augmentor one graph object per dataset, so
    the diffusion functions' cache holds across epochs; a new graph
    object builds the diffusion anew."""
    from rlap_tpu_torch.augment import cca_registry as CR

    g, _y = node_data
    built, inner = [], getattr(CR, cls)

    def counting(*args, **kw):
        built.append(cls)
        return inner(*args, **kw)

    monkeypatch.setattr(CR, cls, counting)
    monkeypatch.setattr(CR, f"_{name.upper()}_CACHE", [None, None])
    tr = CCASSGTrainer(make_cca_augmentor(name, 0.2, 0.2), hidden_dim=16,
                       out_dim=16, seed=0, **CPU)
    assert np.isfinite(tr.fit(g, max_epochs=3)).all()
    assert built == [cls]
    tr.train_epoch(g.replace())
    assert built == [cls, cls]


def test_graphcl_learns(graph_data):
    graphs, y = graph_data
    tr = GraphCLTrainer(*_views(EdgeRemoving(0.2))[::-1], hidden_dim=16,
                        lr=1e-2, batch_size=16, seed=0, **CPU)
    losses = tr.fit(graphs, max_epochs=8, tolerance=8)
    assert np.isfinite(losses).all()
    assert tr.evaluate(graphs, y)["accuracy"] > 0.5


def test_bgrl_learns(graph_data):
    graphs, y = graph_data
    tr = BGRLTrainer(*_views(EdgeRemoving(0.2))[::-1], hidden_dim=16,
                     lr=1e-2, batch_size=16, seed=0, **CPU)
    losses = tr.fit(graphs, max_epochs=10, tolerance=10)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    majority = np.max(np.bincount(y)) / len(y)
    assert tr.evaluate(graphs, y)["accuracy"] >= majority


def test_graphcl_featureless_graphs(graph_data):
    """Graphs without features get x = ones of width 1."""
    graphs, y = graph_data
    bare = [g.replace(x=None) for g in graphs[:20]]
    tr = GraphCLTrainer(Identity(), EdgeRemoving(0.2), hidden_dim=8,
                        batch_size=8, **CPU)
    assert np.isfinite(tr.fit(bare, max_epochs=2)).all()
    assert tr.embed_graphs(bare).shape == (20, 16)


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------

def _node_trainer(kind):
    if kind == "cca_ssg":
        return CCASSGTrainer(make_cca_augmentor("random", 0.2, 0.2),
                             hidden_dim=16, out_dim=16, seed=5, **CPU)
    return MVGRLTrainer(Compose([EdgeRemoving(0.2), FeatureMasking(0.3)]),
                        Compose([RLap(0.2, device="cpu"),
                                 FeatureMasking(0.3)]),
                        hidden_dim=16, seed=7, **CPU)


def _graph_trainer(kind):
    a1 = Compose([EdgeRemoving(0.2), FeatureMasking(0.3)])
    a2 = Compose([RLap(0.2, device="cpu"), FeatureMasking(0.3)])
    cls = BGRLTrainer if kind == "bgrl" else GraphCLTrainer
    return cls(a1, a2, hidden_dim=16, batch_size=16, seed=7, **CPU)


@pytest.mark.parametrize("kind", ["cca_ssg", "mvgrl", "graphcl", "bgrl"])
def test_kill_and_resume(kind, node_data, graph_data, tmp_path):
    if kind in ("cca_ssg", "mvgrl"):
        data, make, total = node_data[0], _node_trainer, 8
    else:
        data, make, total = graph_data[0][:32], _graph_trainer, 5
    ref = make(kind)
    ref_losses = ref.fit(data, max_epochs=total, tolerance=50)
    ck = str(tmp_path / "ck")
    part = make(kind).fit(data, max_epochs=3, tolerance=50,
                          checkpoint_dir=ck, checkpoint_every=1)
    t2 = make(kind)  # a fresh process
    rest = t2.fit(data, max_epochs=total, tolerance=50, checkpoint_dir=ck,
                  checkpoint_every=1)
    assert len(part) == 3 and len(rest) == total - 3
    np.testing.assert_allclose(part + rest, ref_losses, rtol=1e-6)
    for (k, a), b in zip(ref.model.state_dict().items(),
                         t2.model.state_dict().values()):
        _close(a, b.numpy(), rtol=1e-6, atol=0, msg=k)
    if kind == "bgrl":
        for k, v in ref.target_params.items():
            _close(t2.target_params[k], v.numpy(), rtol=1e-6, atol=0, msg=k)


def test_trainers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for make in (lambda: CCASSGTrainer(Identity()),
                 lambda: MVGRLTrainer(Identity(), Identity()),
                 lambda: GraphCLTrainer(Identity(), Identity()),
                 lambda: BGRLTrainer(Identity(), Identity())):
        with pytest.raises((RuntimeError, AssertionError)):
            make()
