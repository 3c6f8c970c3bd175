"""The port's augmentors against the JAX package's, on the same numpy
graphs: the centralities and drop weights (rtol 1e-5), the dense
diffusions (rtol 1e-5, atol 1e-6), the top-k sparsification (exact, on
matrices with ties), every random augmentor given the JAX package's own
draws (exact graphs), the distributional bands of the port's own draws,
and the registries (all 17 + 10 names build valid views, with the
pipelines and parameters of the JAX package's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlap_tpu.augment import adaptive as JA
from rlap_tpu.augment import cca_registry as JCR
from rlap_tpu.augment import diffusion as JD
from rlap_tpu.augment import registry as JR
from rlap_tpu.augment.rw import random_walk_nodes as j_random_walk_nodes
from rlap_tpu.core import graph as JG
from rlap_tpu.data.synthetic import barabasi_albert as j_ba
from rlap_tpu_torch.augment import adaptive as A
from rlap_tpu_torch.augment import cca_registry as CR
from rlap_tpu_torch.augment import diffusion as D
from rlap_tpu_torch.augment import edge as E
from rlap_tpu_torch.augment import registry as R
from rlap_tpu_torch.augment import rw as RW
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.data.synthetic import barabasi_albert

N = 60


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of a thread per core in each of them makes every
    small op wait on threads that are not scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(seed):
    return rng.key(seed, device="cpu")


def to_torch(jg) -> G.Graph:
    """The JAX graph's arrays as a port graph on the CPU."""
    def t(a, dtype=None):
        return None if a is None else torch.tensor(np.asarray(a),
                                                   dtype=dtype)
    return G.Graph(senders=t(jg.senders, torch.int64),
                   receivers=t(jg.receivers, torch.int64),
                   weights=t(jg.weights), num_nodes=jg.num_nodes,
                   x=t(jg.x), node_mask=t(jg.node_mask))


def assert_same_graph(tg, jg):
    assert tg.num_nodes == jg.num_nodes
    np.testing.assert_array_equal(tg.senders.numpy(), np.asarray(jg.senders))
    np.testing.assert_array_equal(tg.receivers.numpy(),
                                  np.asarray(jg.receivers))
    np.testing.assert_array_equal(tg.weights.numpy(), np.asarray(jg.weights))
    if jg.node_mask is not None:
        np.testing.assert_array_equal(tg.node_mask.numpy(),
                                      np.asarray(jg.node_mask))


def _graphs(kind: str):
    """(JAX graph, port graph) alike: a BA graph with features, one with
    random symmetric weights, and a padded union of three small graphs
    with a node mask."""
    r = np.random.default_rng(0)
    if kind == "ba":
        jg = j_ba(N, 3, seed=1)
        jg = jg.replace(x=jnp.asarray(r.normal(size=(N, 8)), jnp.float32))
    elif kind == "weighted":
        jg = j_ba(N, 3, seed=2)
        s, d = np.asarray(jg.senders), np.asarray(jg.receivers)
        w = r.uniform(0.5, 2.0, size=(N + 1, N + 1)).astype(np.float32)
        w = np.triu(w) + np.triu(w, 1).T
        jg = jg.replace(weights=jnp.asarray(
            np.where(s < N, w[s, d], 0.0), jnp.float32))
    else:
        parts = [j_ba(n, 2, seed=n) for n in (12, 20, 9)]
        jg, _ = JG.block_diagonal(parts, node_capacity=48, edge_capacity=256)
    return jg, to_torch(jg)


def _symmetric(g) -> bool:
    a = G.to_dense(g)
    return bool(torch.equal(a, a.T))


def _valid(g) -> None:
    """Indices in range, padding = (sentinel, sentinel, weight 0), finite
    weights."""
    n = g.num_nodes
    assert int(g.senders.min()) >= 0 and int(g.senders.max()) <= n
    assert int(g.receivers.min()) >= 0 and int(g.receivers.max()) <= n
    dead = ~g.edge_mask
    assert bool((g.receivers[dead] == n).all())
    assert bool((g.weights[dead] == 0).all())
    assert bool((g.receivers[g.edge_mask] < n).all())
    assert bool(torch.isfinite(g.weights).all())


# ---------------------------------------------------------------------------
# deterministic pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ba", "weighted", "masked"])
def test_centralities_and_drop_weights_match_jax(kind):
    jg, tg = _graphs(kind)
    jgs, tgs = JG.coalesce(jg), G.coalesce(tg)
    for jf, tf in ((JA.compute_pagerank, A.compute_pagerank),
                   (JA.eigenvector_centrality, A.eigenvector_centrality)):
        np.testing.assert_allclose(tf(tgs).numpy(), np.asarray(jf(jgs)),
                                   rtol=1e-5, err_msg=jf.__name__)
    for jf, tf in ((JA.degree_drop_weights, A.degree_drop_weights),
                   (JA.pr_drop_weights, A.pr_drop_weights),
                   (JA.evc_drop_weights, A.evc_drop_weights)):
        np.testing.assert_allclose(tf(tgs).numpy(), np.asarray(jf(jgs)),
                                   rtol=1e-5, err_msg=jf.__name__)


@pytest.mark.parametrize("kind", ["ba", "weighted", "masked"])
def test_dense_diffusions_match_jax(kind):
    jg, tg = _graphs(kind)
    for loops in (True, False):
        np.testing.assert_allclose(
            D.compute_ppr_dense(tg, add_self_loop=loops).numpy(),
            np.asarray(JD.compute_ppr_dense(jg, add_self_loop=loops)),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            D.compute_markov_dense(tg, add_self_loop=loops).numpy(),
            np.asarray(JD.compute_markov_dense(jg, add_self_loop=loops)),
            rtol=1e-5, atol=1e-6)


def _tied_matrices():
    """A star and a ring (every PPR row has exact ties among equal-degree
    neighbours), and a random matrix rounded to a few levels."""
    star = [(0, i) for i in range(1, 9)]
    ring = [(i, (i + 1) % 10) for i in range(10)]
    out = []
    for n, pairs in ((9, star), (10, ring)):
        s = [a for a, b in pairs] + [b for a, b in pairs]
        d = [b for a, b in pairs] + [a for a, b in pairs]
        jg = JG.Graph.from_edges(np.array(s), np.array(d), n)
        out.append((np.asarray(JD.compute_ppr_dense(jg)), jg))
    r = np.random.default_rng(3)
    levels = np.round(r.random((30, 30)) * 4) / 4
    jg = JG.Graph.from_edges(np.arange(30), (np.arange(30) + 1) % 30, 30,
                             edge_capacity=150)
    out.append((levels.astype(np.float32), jg))
    return out


@pytest.mark.parametrize("case", [0, 1, 2])
@pytest.mark.parametrize("cap", [None, 20, 1000])
def test_dense_to_graph_matches_jax_with_ties(case, cap):
    s, jg = _tied_matrices()[case]
    n = jg.num_nodes
    if case < 2:
        exact = np.asarray(s)
        assert any(len(set(row.tolist())) < n for row in exact)
    got = D.dense_to_graph(torch.tensor(s), to_torch(jg), eps=1e-4,
                           edge_capacity=cap)
    assert_same_graph(got, JD.dense_to_graph(jnp.asarray(s), jg, eps=1e-4,
                                             edge_capacity=cap))


def test_dense_to_graph_row_blocks(monkeypatch):
    """The sort in row blocks gives what one sort gives."""
    s, jg = _tied_matrices()[2]
    whole = D.dense_to_graph(torch.tensor(s), to_torch(jg))
    monkeypatch.setattr(D, "ROW_BLOCK", 7)
    blocked = D.dense_to_graph(torch.tensor(s), to_torch(jg))
    for a, b in zip((whole.senders, whole.receivers, whole.weights),
                    (blocked.senders, blocked.receivers, blocked.weights)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["ba", "masked"])
def test_diffusion_augmentors_on_jax_matrices(kind):
    """PPR and Markov views from the same dense matrix are the same
    graphs (the matrices themselves are held above)."""
    jg, tg = _graphs(kind)
    sp = JD.compute_ppr_dense(jg)
    assert_same_graph(D.dense_to_graph(torch.tensor(np.asarray(sp)), tg),
                      JD.dense_to_graph(sp, jg))
    sm = JD.compute_markov_dense(jg, alpha=0.05)
    assert_same_graph(D.dense_to_graph(torch.tensor(np.asarray(sm)), tg),
                      JD.dense_to_graph(sm, jg))


# ---------------------------------------------------------------------------
# random augmentors on the JAX package's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ba", "weighted", "masked"])
@pytest.mark.parametrize("pe", [0.2, 0.5])
def test_edge_removing_on_jax_draws(kind, pe):
    jg, tg = _graphs(kind)
    key = jax.random.PRNGKey(11)
    want = JR.EdgeRemoving(pe=pe)(jg, key)
    gs = G.coalesce(tg)
    u = torch.tensor(np.asarray(jax.random.uniform(key,
                                                      (gs.edge_capacity,))))
    assert_same_graph(E._keep_canonical(gs, u, pe), want)


@pytest.mark.parametrize("kind", ["ba", "weighted", "masked"])
@pytest.mark.parametrize("pe", [0.1, 0.3, 0.7])
def test_edge_adding_on_jax_draws(kind, pe):
    jg, tg = _graphs(kind)
    key = jax.random.PRNGKey(5)
    want = JR.EdgeAdding(pe=pe)(jg, key)
    half = (max(int(pe * jg.edge_capacity) + 1, 1) + 1) // 2
    k1, k2 = jax.random.split(key)
    u = torch.tensor(np.asarray(jax.random.randint(
        k1, (half,), 0, jg.num_nodes)), dtype=torch.int64)
    v = torch.tensor(np.asarray(jax.random.randint(
        k2, (half,), 0, jg.num_nodes)), dtype=torch.int64)
    assert_same_graph(E._add_pairs(tg, u, v, pe), want)


@pytest.mark.parametrize("kind", ["ba", "masked"])
def test_node_dropping_on_jax_draws(kind):
    jg, tg = _graphs(kind)
    key = jax.random.PRNGKey(2)
    want = JR.NodeDropping(pn=0.3)(jg, key)
    u = torch.tensor(np.asarray(jax.random.uniform(key, (jg.num_nodes,))))
    assert_same_graph(E._drop_nodes(tg, u, 0.3), want)


@pytest.mark.parametrize("name", ["degree", "pr", "evc"])
@pytest.mark.parametrize("kind", ["ba", "masked"])
def test_adaptive_dropping_on_jax_draws(name, kind):
    """The drop given the JAX package's scores and uniforms is its graph
    (the scores themselves are held at rtol 1e-5 above)."""
    jg, tg = _graphs(kind)
    cls = {"degree": JA.EdgeDroppingDegree, "pr": JA.EdgeDroppingPR,
           "evc": JA.EdgeDroppingEVC}[name]
    key = jax.random.PRNGKey(9)
    aug = cls(p=0.3, threshold=0.7)
    want = aug(jg, key)
    jgs = JG.coalesce(jg)
    drop_w = torch.tensor(np.asarray(aug._scores(jgs)))
    u = torch.tensor(np.asarray(jax.random.uniform(key,
                                                      (jgs.edge_capacity,))))
    gs = G.coalesce(tg)
    got = E._keep_canonical(gs, u, A._drop_probability(gs, drop_w, 0.3, 0.7))
    assert_same_graph(got, want)


@pytest.mark.parametrize("kind", ["ba", "masked"])
@pytest.mark.parametrize("num_seeds,walk_length", [(3, 10), (12, 4)])
def test_random_walk_on_jax_draws(kind, num_seeds, walk_length):
    jg, tg = _graphs(kind)
    key = jax.random.PRNGKey(4)
    want = np.asarray(j_random_walk_nodes(jg, key, num_seeds, walk_length))
    k_seed, k_step = jax.random.split(key)
    cur = np.asarray(jax.random.randint(k_seed, (num_seeds,), 0,
                                        jg.num_nodes))
    us = np.stack([np.asarray(jax.random.uniform(k, (num_seeds,)))
                   for k in jax.random.split(k_step, walk_length)])
    got = RW._walk(G.coalesce(tg), torch.tensor(cur, dtype=torch.int64),
                   torch.tensor(us))
    np.testing.assert_array_equal(got.numpy(), want)
    out = JR.RWSampling(num_seeds, walk_length)(jg, key)
    visited = got & tg.node_mask if tg.node_mask is not None else got
    assert_same_graph(G.induced_subgraph(tg, visited), out)


def test_ppr_subgraph_on_jax_draws():
    jg, tg = _graphs("ba")
    key = jax.random.PRNGKey(8)
    want = JD.PPRDiffusionSubGraph(sub_graph_size=20)(jg, key)
    sp = JD.compute_ppr_dense(jg)
    out = D.dense_to_graph(torch.tensor(np.asarray(sp)), tg)
    perm = torch.tensor(np.asarray(jax.random.permutation(key, N)))
    assert_same_graph(D._restrict_to_first(out, perm, 20), want)


# ---------------------------------------------------------------------------
# the port's own draws: bands
# ---------------------------------------------------------------------------

def _big():
    return barabasi_albert(400, 5, seed=3, device="cpu")


def _pairs_alive(g) -> int:
    return int((g.edge_mask & (g.senders < g.receivers)).sum())


@pytest.mark.parametrize("pe", [0.2, 0.5])
def test_edge_removing_band(pe):
    g = _big()
    fracs = []
    for seed in range(4):
        out = E.EdgeRemoving(pe)(g, _key(seed))
        _valid(out)
        assert _symmetric(out)
        fracs.append(_pairs_alive(out) / _pairs_alive(g))
    assert abs(np.mean(fracs) - (1 - pe)) < 0.03, fracs


def test_edge_adding_band():
    g = _big()
    e0 = int(g.num_edges)
    out = E.EdgeAdding(0.2)(g, _key(0))
    _valid(out)
    assert _symmetric(out)
    added = int(out.num_edges) - e0
    # int(0.2 E) directed slots, less the loops and the pairs already there
    assert 0.9 * int(0.2 * e0) <= added <= int(0.2 * e0) + 1, (added, e0)
    assert bool((out.weights[out.edge_mask] == 1).all())


def test_node_dropping_band():
    g = _big()
    out = E.NodeDropping(0.3)(g, _key(1))
    _valid(out)
    assert _symmetric(out)
    dropped = int((G.degrees(out) == 0).sum())
    assert abs(dropped / 400 - 0.3) < 0.08, dropped


@pytest.mark.parametrize("cls", [A.EdgeDroppingDegree, A.EdgeDroppingPR,
                                 A.EdgeDroppingEVC])
def test_adaptive_dropping_band(cls):
    g = _big()
    gs = G.coalesce(g)
    aug = cls(p=0.3, threshold=0.7)
    prob = A._drop_probability(gs, aug._scores(gs), 0.3, 0.7)
    want = 1 - float(prob[gs.edge_mask].mean())
    fracs = []
    for seed in range(4):
        out = aug(g, _key(seed))
        _valid(out)
        fracs.append(int(out.num_edges) / int(g.num_edges))
    assert abs(np.mean(fracs) - want) < 0.03, (fracs, want)


def test_random_walk_band():
    g = _big()
    visited = RW.random_walk_nodes(g, _key(0), 20, 10)
    # at least the seeds' distinct starts, at most 20 walks x 11 nodes
    assert 15 <= int(visited.sum()) <= 220
    out = RW.RWSampling(20, 10)(g, _key(0))
    _valid(out)
    assert _symmetric(out)
    assert bool(torch.equal(G.degrees(out) > 0, visited & (G.degrees(g) > 0)))


# ---------------------------------------------------------------------------
# the registries
# ---------------------------------------------------------------------------

_PARAMS = ("pe", "pn", "p", "threshold", "frac", "o_v", "o_n",
           "keep_weights", "alpha", "eps", "iters", "order", "add_self_loop",
           "edge_capacity", "num_seeds", "walk_length", "pf", "refresh_every",
           "sub_graph_size", "num_choices")


def describe(aug):
    """A pipeline as nested (class name, parameters, children)."""
    params = {k: getattr(aug, k) for k in _PARAMS if hasattr(aug, k)}
    kids = list(getattr(aug, "augmentors", []))
    for name in ("inner", "rlap"):
        if hasattr(aug, name):
            kids.append(getattr(aug, name))
    return (type(aug).__name__, params, [describe(k) for k in kids])


NAMES = R.AUGMENTOR_NAMES + ("rLapPPRDiffusion",)


def test_registry_names_match_jax():
    assert R.AUGMENTOR_NAMES == JR.AUGMENTOR_NAMES
    assert list(CR.CCA_AUGMENTORS) == list(JCR.CCA_AUGMENTORS)
    with pytest.raises(ValueError):
        R.make_augmentor_pair("nope", 0.2, 0.2)


@pytest.mark.parametrize("name", NAMES)
def test_registry_pipeline_matches_jax(name):
    for use_cache in (True, False):
        got = R.make_augmentor_pair(name, 0.2, 0.3, num_nodes=N, pf=0.25,
                                    use_cache=use_cache, device="cpu")
        want = JR.make_augmentor_pair(name, 0.2, 0.3, num_nodes=N, pf=0.25,
                                      use_cache=use_cache)
        assert [describe(a) for a in got] == [describe(a) for a in want]


# diffusion views keep each row's top k; the adaptive drops share one coin
# per pair but give the two directions the probabilities of their own
# receivers, as the JAX package does
_NOT_SYMMETRIC = ("PPRDiffusion", "MarkovDiffusion", "rLapPPRDiffusion",
                  "EdgeDroppingDegree", "EdgeDroppingPR", "EdgeDroppingEVC",
                  "markovd", "pprd", "ed_deg", "ed_ppr", "ed_evc")


@pytest.mark.parametrize("name", NAMES)
def test_registry_views_are_valid(name):
    g, tg = _graphs("ba")
    for i, aug in enumerate(R.make_augmentor_pair(name, 0.2, 0.3,
                                                  num_nodes=N,
                                                  device="cpu")):
        out = aug(tg, _key(i))
        _valid(out)
        assert out.num_nodes == N and out.x.shape == tg.x.shape
        if name not in _NOT_SYMMETRIC:
            assert _symmetric(out), name
        # feature masking zeroed whole columns and nothing else
        zero_cols = (out.x == 0).all(0)
        assert bool(torch.equal(out.x[:, ~zero_cols], tg.x[:, ~zero_cols]))


@pytest.mark.parametrize("name", list(CR.CCA_AUGMENTORS))
def test_cca_views_are_valid(name):
    _, tg = _graphs("ba")
    fn = CR.make_cca_augmentor(name, 0.2, 0.3)
    out = fn(tg, _key(0))
    _valid(out)
    assert out.num_nodes == N and out.x.shape == tg.x.shape
    if name not in _NOT_SYMMETRIC:
        assert _symmetric(out), name
    if name in ("markovd", "pprd"):
        # the diffusion is computed once per graph object
        again = fn(tg, _key(1))
        assert bool(torch.equal(again.senders, out.senders))


def _cca_topology(name, tg, k1, frac):
    """The port's topology half of a CCA-SSG function, given the JAX
    package's key `k1` for that half."""
    n = tg.num_nodes
    if name == "random":
        gs = G.coalesce(tg)
        return E._keep_canonical(gs, torch.tensor(np.asarray(
            jax.random.uniform(k1, (gs.edge_capacity,)))), frac)
    if name == "nd":  # frac is the keep probability
        return E._drop_nodes(tg, torch.tensor(np.asarray(
            jax.random.uniform(k1, (n,)))), 1.0 - frac)
    if name == "ea":
        half = (max(int(frac * tg.edge_capacity) + 1, 1) + 1) // 2
        ka, kb = jax.random.split(k1)
        u, v = (torch.tensor(np.asarray(jax.random.randint(k, (half,), 0, n)),
                             dtype=torch.int64) for k in (ka, kb))
        return E._add_pairs(tg, u, v, frac)
    if name == "ed_deg":
        gs = G.coalesce(tg)
        u = torch.tensor(np.asarray(jax.random.uniform(k1,
                                                       (gs.edge_capacity,))))
        prob = A._drop_probability(gs, A.degree_drop_weights(gs), frac, 0.7)
        return E._keep_canonical(gs, u, prob)
    seeds = max(int(frac * n), 1)  # rws: walks of 10 steps
    k_seed, k_step = jax.random.split(k1)
    cur = torch.tensor(np.asarray(jax.random.randint(k_seed, (seeds,), 0, n)),
                       dtype=torch.int64)
    us = torch.tensor(np.stack([np.asarray(jax.random.uniform(k, (seeds,)))
                                for k in jax.random.split(k_step, 10)]))
    return G.induced_subgraph(tg, RW._walk(G.coalesce(tg), cur, us))


@pytest.mark.parametrize("name", ["random", "nd", "ea", "ed_deg", "rws"])
def test_cca_functions_on_jax_draws(name):
    """A CCA-SSG function with the feature mask, given the JAX package's
    draws for both halves, is its graph and features: the function maps
    `frac` to the augmentor's parameter as the JAX package does."""
    jg, tg = _graphs("ba")
    key = jax.random.PRNGKey(6)
    want = JCR.CCA_AUGMENTORS[name](jg, key, 0.25, 0.3)
    k1, k2 = jax.random.split(key)
    out = _cca_topology(name, tg, k1, 0.3)
    keep = torch.tensor(np.asarray(jax.random.uniform(k2, (8,)))) >= 0.25
    out = out.replace(x=out.x * keep.to(out.x.dtype)[None, :])
    assert_same_graph(out, want)
    np.testing.assert_array_equal(out.x.numpy(), np.asarray(want.x))
