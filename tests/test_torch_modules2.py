"""Plain modules of the port against the JAX package on the same numpy
inputs: graph batching helpers and the graph dataset (exact), the
augmentor wrappers (structure and schedule: the random draws differ by
generator), `MLP` / `MaskedBatchNorm` with converted parameters (forward
and gradients, rtol 1e-5), pooling (rtol 1e-6), and `jsd`,
`bootstrap_latent`, G2G and G2L (loss and gradients, rtol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlap_tpu.augment import base as JA
from rlap_tpu.core import graph as JG
from rlap_tpu.data import synthetic as JS
from rlap_tpu.models.common import make_union_batches as j_union
from rlap_tpu.nn import layers as JL
from rlap_tpu.objectives import contrast as JC
from rlap_tpu_torch.augment import base as TA
from rlap_tpu_torch.augment.feature import FeatureDropout, FeatureMasking
from rlap_tpu_torch.convert import flax_to_state_dict, load_flax_params
from rlap_tpu_torch.core import graph as TG
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.data import synthetic as TS
from rlap_tpu_torch.models.common import make_union_batches as t_union
from rlap_tpu_torch.nn import layers as TL
from rlap_tpu_torch.objectives import contrast as TC

RTOL, ATOL = 1e-5, 1e-6


def _same(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.detach().cpu().numpy())


def _same_graph(jg, tg):
    assert jg.num_nodes == tg.num_nodes
    for name in ("senders", "receivers", "weights", "x", "node_mask"):
        j, t = getattr(jg, name), getattr(tg, name)
        assert (j is None) == (t is None), name
        if j is not None:
            _same(j, t)


def _pair(n=40, e=300, cap=512, seed=0):
    """Duplicates, self-loops and zero weights, padded to `cap`; weights
    are multiples of 1/2, so sums are exact in any order."""
    r = np.random.default_rng(seed)
    s, d = r.integers(0, n, e), r.integers(0, n, e)
    w = r.integers(0, 4, e) / 2.0
    return (JG.Graph.from_edges(s, d, n, weights=w, edge_capacity=cap),
            TG.Graph.from_edges(s, d, n, weights=w, edge_capacity=cap,
                                device="cpu"))


# ---------------------------------------------------------------------------
# core/graph.py and data/synthetic.py: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduce", ["max", "sum"])
def test_to_undirected_matches_jax(reduce):
    jg, tg = _pair()
    ju, tu = JG.to_undirected(jg, reduce), TG.to_undirected(tg, reduce)
    _same_graph(ju, tu)
    assert tu.edge_capacity == 2 * tg.edge_capacity
    if reduce == "max":  # a symmetric graph is a fixed point
        again = TG.to_undirected(tu)
        d1, d2 = TG.to_dense(tu), TG.to_dense(again)
        assert torch.equal(d1, d2) and torch.equal(d1, d1.T)


def test_induced_subgraph_matches_jax():
    jg, tg = _pair(seed=1)
    keep = np.random.default_rng(2).random(40) < 0.6
    _same_graph(JG.induced_subgraph(jg, jnp.asarray(keep)),
                TG.induced_subgraph(tg, torch.tensor(keep)))
    out = TG.induced_subgraph(tg, torch.tensor(keep))
    live = out.edge_mask
    assert bool(torch.tensor(keep)[out.senders[live]].all())
    assert bool(torch.tensor(keep)[out.receivers[live]].all())


def test_mirror_indices_matches_jax():
    jg = JS.barabasi_albert(50, 3, seed=3)
    tg = TS.barabasi_albert(50, 3, seed=3, device="cpu")
    jm, tm = JG.mirror_indices(jg), TG.mirror_indices(tg)
    _same(jm, tm)
    e = int(tg.num_edges)
    assert torch.equal(tg.senders[tm[:e]], tg.receivers[:e])
    assert torch.equal(tg.receivers[tm[:e]], tg.senders[:e])


@pytest.mark.parametrize("features", ["x", "ones", "none"])
def test_block_diagonal_matches_jax(features):
    jgs, _ = JS.synthetic_graph_dataset(num_graphs=5, seed=4)
    tgs, _ = TS.synthetic_graph_dataset(num_graphs=5, seed=4, device="cpu")
    if features != "x":
        jgs = [g.replace(x=None) for g in jgs]
        tgs = [g.replace(x=None) for g in tgs]
    kw = dict(node_capacity=256, edge_capacity=1024,
              feature_dim=3 if features == "ones" else None)
    (jb, jseg), (tb, tseg) = JG.block_diagonal(jgs, **kw), \
        TG.block_diagonal(tgs, device="cpu", **kw)
    _same_graph(jb, tb)
    _same(jseg, tseg)
    assert (tb.x is None) == (features == "none")
    total = sum(g.num_nodes for g in tgs)
    assert int(tb.node_mask.sum()) == total
    with pytest.raises(ValueError):
        TG.block_diagonal(tgs, node_capacity=total - 1, edge_capacity=1024,
                          device="cpu")
    with pytest.raises(ValueError):
        TG.block_diagonal(tgs, node_capacity=256, edge_capacity=8,
                          device="cpu")


def test_synthetic_graph_dataset_matches_jax():
    jgs, jy = JS.synthetic_graph_dataset(num_graphs=12, num_classes=3,
                                         feature_dim=5, seed=9)
    tgs, ty = TS.synthetic_graph_dataset(num_graphs=12, num_classes=3,
                                         feature_dim=5, seed=9, device="cpu")
    np.testing.assert_array_equal(jy, ty)
    assert len(jgs) == len(tgs) == 12
    for jg, tg in zip(jgs, tgs):
        _same_graph(jg, tg)


def test_make_union_batches_matches_jax():
    jgs, _ = JS.synthetic_graph_dataset(num_graphs=10, seed=2)
    tgs, _ = TS.synthetic_graph_dataset(num_graphs=10, seed=2, device="cpu")
    jbs = j_union(jgs, batch_size=4, shuffle_seed=5)
    tbs = t_union(tgs, batch_size=4, shuffle_seed=5, device="cpu")
    assert [b[2] for b in jbs] == [b[2] for b in tbs] == [4, 4, 2]
    for (jb, jseg, _), (tb, tseg, _) in zip(jbs, tbs):
        _same_graph(jb, tb)
        _same(jseg, tseg)
    assert len({b[0].edge_capacity for b in tbs}) == 1


# ---------------------------------------------------------------------------
# augmentor wrappers: structure and schedule
# ---------------------------------------------------------------------------

def _feature_graph(n=64, f=32, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32) + 3
    return TS.barabasi_albert(n, 2, seed=seed, device="cpu").replace(
        x=torch.tensor(x))


def test_feature_dropout_zeroes_elements():
    g = _feature_graph()
    out = FeatureDropout(0.3)(g, rng.key(0, device="cpu"))
    dropped = out.x == 0
    assert torch.equal(out.x[~dropped], g.x[~dropped])
    assert 0.2 < float(dropped.float().mean()) < 0.4
    # per element, not per column as FeatureMasking
    per_col = dropped.float().mean(0)
    assert bool(((per_col > 0) & (per_col < 1)).all())
    assert torch.equal(out.senders, g.senders)
    again = FeatureDropout(0.3)(g, rng.key(0, device="cpu"))
    assert torch.equal(out.x, again.x)
    bare = g.replace(x=None)
    assert FeatureDropout(0.3)(bare, rng.key(0, device="cpu")) is bare


class _Tag(TA.Augmentor):
    """Adds `value` to x, and counts its calls."""

    def __init__(self, value):
        self.value, self.calls = value, 0

    def augment(self, g, key):
        self.calls += 1
        return g.replace(x=g.x + self.value)


def test_random_choice_applies_num_choices():
    g = _feature_graph(8, 2).replace(x=torch.zeros(8, 2))
    seen = set()
    for seed in range(12):
        augs = [_Tag(1.0), _Tag(10.0), _Tag(100.0)]
        out = TA.RandomChoice(augs, num_choices=2)(
            g, rng.key(seed, device="cpu"))
        assert sorted(a.calls for a in augs) == [0, 1, 1]  # no replacement
        total = float(out.x[0, 0])
        assert total in (11.0, 101.0, 110.0)
        seen.add(total)
        again = TA.RandomChoice([_Tag(1.0), _Tag(10.0), _Tag(100.0)], 2)(
            g, rng.key(seed, device="cpu"))
        assert torch.equal(out.x, again.x)  # a function of the key
    assert len(seen) > 1
    one = TA.RandomChoice([_Tag(1.0), _Tag(10.0)])  # the JAX default: 1
    assert float(one(g, rng.key(0, device="cpu")).x[0, 0]) in (1.0, 10.0)


def test_random_choice_feeds_stage_keys():
    """The j-th chosen augmentor gets fold_in(key, j + 1), as in JAX."""
    got = []

    class Spy(TA.Augmentor):
        def augment(self, g, key):
            got.append(key.initial_seed())
            return g

    key = rng.key(5, device="cpu")
    TA.RandomChoice([Spy(), Spy(), Spy()], num_choices=3)(
        _feature_graph(8, 2), key)
    assert got == [rng.fold_in(key, j + 1).initial_seed() for j in range(3)]


@pytest.mark.parametrize("refresh_every", [1, 3])
def test_cached_augmentor_refresh_schedule_matches_jax(refresh_every):
    class JCount(JA.Augmentor):
        calls = 0

        def augment(self, g, key):
            self.calls += 1
            return (g, self.calls)

    class TCount(TA.Augmentor):
        calls = 0

        def augment(self, g, key):
            self.calls += 1
            return (g, self.calls)

    ji, ti = JCount(), TCount()
    jc = JA.CachedAugmentor(ji, refresh_every)
    tc = TA.CachedAugmentor(ti, refresh_every)
    jseen = [jc("g", None)[1] for _ in range(8)]
    tseen = [tc("g", None)[1] for _ in range(8)]
    assert jseen == tseen
    assert ti.calls == ji.calls == -(-8 // refresh_every)


def test_cached_augmentor_returns_the_cached_view():
    g = _feature_graph()
    cached = TA.CachedAugmentor(FeatureMasking(0.5), refresh_every=2)
    a = cached(g, rng.key(0, device="cpu"))
    b = cached(g, rng.key(1, device="cpu"))
    c = cached(g, rng.key(2, device="cpu"))
    assert b is a and c is not a
    assert not torch.equal(a.x, c.x)


# ---------------------------------------------------------------------------
# nn/layers.py
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().numpy()


def _grad_check(jloss, params, tmodule, tloss):
    jgrads = flax_to_state_dict(jax.grad(jloss)(params))
    tloss().backward()
    named = dict(tmodule.named_parameters())
    assert set(named) == set(jgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(_np(named[name].grad), g.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("activate_final", [False, True])
def test_mlp_matches_flax(activate_final):
    x = np.random.default_rng(0).normal(size=(30, 12)).astype(np.float32)
    r = np.random.default_rng(1).normal(size=(30, 7)).astype(np.float32) / 30
    jm = JL.MLP([16, 16, 7], activate_final=activate_final)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = load_flax_params(TL.MLP(12, [16, 16, 7],
                                 activate_final=activate_final), params)
    np.testing.assert_allclose(
        _np(tm(torch.tensor(x))),
        np.asarray(jm.apply({"params": params}, jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)
    _grad_check(
        lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * r),
        params, tm, lambda: (tm(torch.tensor(x)) * torch.tensor(r)).sum())


def test_mlp_initialiser_follows_flax():
    mlp = TL.MLP(400, [300, 10], generator=torch.Generator().manual_seed(0))
    std = float(mlp.dense_0.weight.detach().std())  # lecun normal
    assert abs(std - (1 / 400) ** 0.5) < 0.002
    assert float(mlp.dense_0.bias.detach().abs().max()) == 0.0
    assert [n for n, _ in mlp.named_parameters()] == [
        "dense_0.weight", "dense_0.bias", "dense_1.weight", "dense_1.bias"]


@pytest.mark.parametrize("masked", [False, True])
def test_masked_batch_norm_matches_flax(masked):
    rs = np.random.default_rng(3)
    x = (rs.normal(size=(40, 6)) * 2 + 1).astype(np.float32)
    r = rs.normal(size=(40, 6)).astype(np.float32) / 40
    mask = rs.random(40) < 0.7 if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.tensor(mask)
    jm = JL.MaskedBatchNorm()
    var = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.arange(a.shape[0], dtype=np.float32),
        var["params"])
    stats = var["batch_stats"]
    tm = load_flax_params(TL.MaskedBatchNorm(6), params, stats)

    jout, upd = jm.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x), mask=jmask, mutable=["batch_stats"])
    tout = tm(torch.tensor(x), mask=tmask)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=RTOL,
                               atol=ATOL)
    for name in ("mean", "var"):  # the running statistics moved alike
        np.testing.assert_allclose(_np(getattr(tm, name)),
                                   np.asarray(upd["batch_stats"][name]),
                                   rtol=RTOL, atol=ATOL)
    if masked:  # padding rows do not move the statistics
        x2 = x.copy()
        x2[~mask] = 1e3
        again = load_flax_params(TL.MaskedBatchNorm(6), params, stats)(
            torch.tensor(x2), mask=tmask)
        np.testing.assert_allclose(_np(again)[mask], _np(tout)[mask],
                                   rtol=RTOL, atol=ATOL)

    # evaluation: the running statistics, not the batch's
    jev = jm.apply({"params": params, "batch_stats": upd["batch_stats"]},
                   jnp.asarray(x), mask=jmask, use_running_average=True)
    before = tm.mean.clone()
    tev = tm(torch.tensor(x), mask=tmask, use_running_average=True)
    np.testing.assert_allclose(_np(tev), np.asarray(jev), rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(tm.mean, before)

    def jloss(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats},
                          jnp.asarray(x), mask=jmask,
                          mutable=["batch_stats"])
        return jnp.sum(out * r)

    tm2 = load_flax_params(TL.MaskedBatchNorm(6), params, stats)
    xt = torch.tensor(x, requires_grad=True)
    _grad_check(jloss, params, tm2,
                lambda: (tm2(xt, mask=tmask) * torch.tensor(r)).sum())
    jdx = jax.grad(lambda xx: jnp.sum(jm.apply(
        {"params": params, "batch_stats": stats}, xx, mask=jmask,
        mutable=["batch_stats"])[0] * r))(jnp.asarray(x))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jdx), rtol=1e-4,
                               atol=ATOL)


@pytest.mark.parametrize("pool", ["add", "mean"])
def test_pooling_matches_jax(pool):
    rs = np.random.default_rng(4)
    x = rs.normal(size=(50, 5)).astype(np.float32)
    seg = rs.integers(0, 7, 50)  # id 6 = padding (num_graphs); 5 is empty
    seg[seg == 5] = 6
    jf = getattr(JL, f"global_{pool}_pool")
    tf = getattr(TL, f"global_{pool}_pool")
    got = tf(torch.tensor(x), torch.tensor(seg), 6)
    assert got.shape == (6, 5)
    np.testing.assert_allclose(
        _np(got), np.asarray(jf(jnp.asarray(x), jnp.asarray(seg), 6)),
        rtol=1e-6, atol=1e-6)
    assert float(got[5].abs().max()) == 0.0  # an empty graph pools to 0


# ---------------------------------------------------------------------------
# objectives/contrast.py
# ---------------------------------------------------------------------------

def _emb(n, f, seed):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


def _loss_and_grads(jfn, tfn, arrays):
    """jfn / tfn take the arrays (jnp / torch) and return a scalar; values
    and the gradients w.r.t. every array within rtol 1e-5."""
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.tensor(a, requires_grad=True) for a in arrays]
    jval, jgrads = jax.value_and_grad(
        lambda *a: jfn(*a), argnums=tuple(range(len(arrays))))(*jargs)
    tval = tfn(*targs)
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=RTOL,
                               atol=ATOL)
    for jg, t in zip(jgrads, targs):
        np.testing.assert_allclose(_np(t.grad), np.asarray(jg), rtol=RTOL,
                                   atol=ATOL)


def _masks(seed=0, graphs=4, n=30):
    rs = np.random.default_rng(seed)
    seg = rs.integers(0, graphs, n)
    seg[-4:] = graphs  # padding nodes
    node_mask = seg < graphs
    node_mask[0] = False
    return seg, node_mask


@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_scale_masks_match_jax(with_mask):
    seg, node_mask = _masks()
    jm = jnp.asarray(node_mask) if with_mask else None
    tm = torch.tensor(node_mask) if with_mask else None
    jp, jn = JC.cross_scale_masks_batched(jnp.asarray(seg), 4, jm)
    tp, tn = TC.cross_scale_masks_batched(torch.tensor(seg), 4, tm)
    _same(jp, tp)
    _same(jn, tn)
    assert float((tp * tn).sum()) == 0.0
    assert float(tp[:, -4:].sum() + tn[:, -4:].sum()) == 0.0


def test_jsd_matches_jax():
    seg, node_mask = _masks(1)
    jp, jn = JC.cross_scale_masks_batched(jnp.asarray(seg), 4,
                                          jnp.asarray(node_mask))
    tp, tn = torch.tensor(np.asarray(jp)), torch.tensor(np.asarray(jn))
    _loss_and_grads(lambda a, s: JC.jsd(a, s, jp, jn),
                    lambda a, s: TC.jsd(a, s, tp, tn),
                    [_emb(4, 8, 0), _emb(30, 8, 1)])


def test_jsd_masks_before_the_softplus():
    """The reference's order, kept for parity: a masked-out pair still adds
    log 2 - softplus(0) = 0 to e_pos, and softplus(0) - log 2 = 0 to
    e_neg, so only the counts see the mask."""
    a, s = torch.tensor(_emb(3, 4, 0)), torch.tensor(_emb(5, 4, 1))
    pos = torch.zeros(3, 5)
    pos[0, 0] = 1.0
    neg = 1.0 - pos
    sim = a @ s.T
    want = ((torch.nn.functional.softplus(-sim * neg) + sim * neg
             - np.log(2.0)).sum() / neg.sum()
            - (np.log(2.0) - torch.nn.functional.softplus(-sim * pos)).sum())
    np.testing.assert_allclose(float(TC.jsd(a, s, pos, neg)), float(want),
                               rtol=1e-6)


def test_bootstrap_latent_matches_jax():
    pos = np.eye(20, dtype=np.float32)
    pos[3] = 0.0  # an anchor with no positive is left out of the mean
    pos[5, 6] = 1.0
    _loss_and_grads(
        lambda a, s: JC.bootstrap_latent(a, s, jnp.asarray(pos)),
        lambda a, s: TC.bootstrap_latent(a, s, torch.tensor(pos)),
        [_emb(20, 8, 2), _emb(20, 8, 3)])


@pytest.mark.parametrize("loss", ["infonce", "jsd", "bootstrap"])
def test_g2g_matches_jax(loss):
    jc = JC.DualBranchContrast(loss=loss, mode="G2G", tau=0.3)
    tc = TC.DualBranchContrast(loss=loss, mode="G2G", tau=0.3)
    _loss_and_grads(lambda a, b: jc(g1=a, g2=b), lambda a, b: tc(g1=a, g2=b),
                    [_emb(12, 8, 4), _emb(12, 8, 5)])


@pytest.mark.parametrize("loss", ["infonce", "jsd", "bootstrap"])
def test_g2l_batched_matches_jax(loss):
    seg, node_mask = _masks(2)
    jc = JC.DualBranchContrast(loss=loss, mode="G2L", tau=0.3)
    tc = TC.DualBranchContrast(loss=loss, mode="G2L", tau=0.3)
    _loss_and_grads(
        lambda h1, h2, g1, g2: jc(h1=h1, h2=h2, g1=g1, g2=g2,
                                  segment_ids=jnp.asarray(seg), num_graphs=4,
                                  node_mask=jnp.asarray(node_mask)),
        lambda h1, h2, g1, g2: tc(h1=h1, h2=h2, g1=g1, g2=g2,
                                  segment_ids=torch.tensor(seg), num_graphs=4,
                                  node_mask=torch.tensor(node_mask)),
        [_emb(30, 8, 6), _emb(30, 8, 7), _emb(4, 8, 8), _emb(4, 8, 9)])


@pytest.mark.parametrize("loss,with_mask", [("jsd", False), ("jsd", True),
                                            ("infonce", True)])
def test_g2l_single_graph_matches_jax(loss, with_mask):
    """One graph: its summary against its nodes (positives) and the
    corrupted nodes h3/h4 (negatives), the MVGRL wiring."""
    node_mask = np.random.default_rng(3).random(25) < 0.8
    jm = jnp.asarray(node_mask) if with_mask else None
    tm = torch.tensor(node_mask) if with_mask else None
    jc = JC.DualBranchContrast(loss=loss, mode="G2L")
    tc = TC.DualBranchContrast(loss=loss, mode="G2L")
    _loss_and_grads(
        lambda h1, h2, h3, h4, g1, g2: jc(h1=h1, h2=h2, h3=h3, h4=h4, g1=g1,
                                          g2=g2, node_mask=jm),
        lambda h1, h2, h3, h4, g1, g2: tc(h1=h1, h2=h2, h3=h3, h4=h4, g1=g1,
                                          g2=g2, node_mask=tm),
        [_emb(25, 8, s) for s in range(4)] + [_emb(1, 8, 10), _emb(1, 8, 11)])


@pytest.mark.parametrize("loss", ["jsd", "bootstrap"])
def test_l2l_mask_losses_match_jax(loss):
    node_mask = np.random.default_rng(5).random(24) < 0.8
    jc = JC.DualBranchContrast(loss=loss, mode="L2L")
    tc = TC.DualBranchContrast(loss=loss, mode="L2L")
    _loss_and_grads(
        lambda a, b: jc(h1=a, h2=b, node_mask=jnp.asarray(node_mask)),
        lambda a, b: tc(a, b, node_mask=torch.tensor(node_mask)),
        [_emb(24, 8, 12), _emb(24, 8, 13)])
