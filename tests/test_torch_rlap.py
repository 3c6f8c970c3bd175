"""The port's rLap elimination, held by the structural tests of
`tests/test_rlap_op.py` and by the spectral-expectation bands of
`tests/test_spectral_parity.py` against the C++ oracle. The two packages
draw from different generators, so rLap outputs agree in distribution, not
bit for bit."""

import numpy as np
import pytest
import torch

from rlap_tpu.native import oracle_approximate_cholesky
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.data.synthetic import barabasi_albert
from rlap_tpu_torch.ops.rlap import (approximate_cholesky, eliminate,
                                     eliminate_pair)


def _ba(n, m, seed):
    return barabasi_albert(n, m, seed=seed, device="cpu")


def _dense(g):
    return G.to_dense(g).numpy()


def _approx(g, seed, t, **kw):
    return approximate_cholesky(g, rng.key(seed, device="cpu"), t, device="cpu", **kw)


@pytest.mark.parametrize("o_v", ["random", "degree", "coarsen"])
@pytest.mark.parametrize("o_n", ["asc", "desc", "random"])
def test_output_symmetric_and_sized(o_v, o_n):
    g = _ba(100, 3, 7)
    out = _approx(g, 0, 50, o_v=o_v, o_n=o_n)
    d = _dense(out)
    np.testing.assert_allclose(d, d.T, atol=1e-5)
    assert ((d > 0).sum(1) == 0).sum() == 50  # BA is connected
    w = out.weights[out.edge_mask]
    assert bool((w > 0).all())
    assert out.edge_capacity == g.edge_capacity


def test_eliminates_requested_count():
    out, removed, rounds = eliminate(_ba(100, 2, 3), rng.key(1, device="cpu"), 60)
    assert removed == 60 and rounds >= 1
    assert int((G.degrees(out) > 0).sum()) == 40


def test_num_remove_zero_is_identity():
    g = _ba(50, 2, 0)
    np.testing.assert_allclose(_dense(_approx(g, 0, 0)), _dense(g),
                               atol=1e-6)


def test_last_vertex_never_eliminated():
    out, removed, _ = eliminate(_ba(30, 2, 1), rng.key(2, device="cpu"), 30)
    assert removed == 29


def test_single_elimination_exact_weights():
    """Star 0-(1,2,3) with weights 3, 2, 1: eliminating the centre in asc
    order (1, 2, 3; csum 6) emits 1*5/6 and 2*3/6."""
    g = G.Graph.from_edges([0, 0, 0, 1, 2, 3], [1, 2, 3, 0, 0, 0], 4,
                           weights=[3.0, 2.0, 1.0, 3.0, 2.0, 1.0],
                           device="cpu")
    seen = 0
    for seed in range(20):
        d = _dense(_approx(g, seed, 1, o_v="random", o_n="asc"))
        if d[0].sum() != 0:
            continue  # a leaf was eliminated instead
        seen += 1
        vals = sorted(set(np.round(d[d > 0], 5)))
        np.testing.assert_allclose(vals, [np.round(5 / 6, 5), 1.0])
    assert seen > 0


def test_total_weight_conservation_random():
    g = _ba(60, 3, 5)
    w_in = float(g.weights.sum())
    w_out = float(_approx(g, 2, 1, o_v="random", o_n="random").weights.sum())
    assert w_out < w_in
    assert w_in - w_out <= 2 * float(G.weighted_degrees(g).max()) + 1e-4


def test_coarsen_harmonic_weights():
    """Coarsening one node of a 4-cycle of weight 2: a path of weights
    {2, 2} plus one rewired edge of harmonic weight 2*2/(2+2) = 1."""
    g = G.Graph.from_edges([0, 1, 1, 2, 2, 3, 3, 0],
                           [1, 0, 2, 1, 3, 2, 0, 3], 4, weights=[2.0] * 8,
                           device="cpu")
    d = _dense(_approx(g, 4, 1, o_v="coarsen", o_n="random"))
    np.testing.assert_allclose(d, d.T, atol=1e-6)
    vals = d[np.triu_indices(4, 1)]
    np.testing.assert_allclose(np.sort(vals[vals > 0]), [1.0, 2.0, 2.0],
                               rtol=1e-5)


@pytest.mark.parametrize("schedule", ["fast", "luby"])
def test_ring_stays_a_ring(schedule):
    """The Schur complement of a ring is a ring on the survivors."""
    n, t = 3000, 1200
    idx = np.arange(n)
    g = G.Graph.from_edges(np.concatenate([idx, (idx + 1) % n]),
                           np.concatenate([(idx + 1) % n, idx]), n,
                           device="cpu")
    out, removed, _ = eliminate(g, rng.key(5, device="cpu"), t, schedule=schedule)
    assert removed == t
    assert int(out.num_edges) == 2 * (n - t)
    assert bool((G.degrees(out)[G.degrees(out) > 0] == 2).all())


def test_eliminate_pair_equals_two_singles():
    g = _ba(300, 4, 4)
    key = rng.key(9, device="cpu")
    views = eliminate_pair(g, key, 120, o_n="asc")
    for (gp, rm, rounds), kv in zip(views, rng.split(key)):
        ref, rmr, rr = eliminate(g, kv, 120, o_n="asc")
        assert rm == rmr == 120 and rounds == rr
        assert torch.equal(gp.senders, ref.senders)
        assert torch.equal(gp.receivers, ref.receivers)
        assert torch.equal(gp.weights, ref.weights)
    assert not torch.equal(views[0][0].senders, views[1][0].senders)


@pytest.mark.parametrize("o_v,sampler", [("degree", "independent"),
                                         ("coarsen", "independent"),
                                         ("degree", "race")])
def test_rounds_of_nodes_without_edges(o_v, sampler):
    """With o_v "degree" or "coarsen" the nodes without edges go first, so
    a round can eliminate only such nodes and touch no edge; it removes
    them and leaves the graph as it was (the oracle counts them too)."""
    g = _ba(50, 2, 4)
    g = G.Graph.from_edges(g.senders[g.edge_mask], g.receivers[g.edge_mask],
                           num_nodes=60, device="cpu")
    out, removed, rounds = eliminate(g, rng.key(3, device="cpu"), 10,
                                     o_v=o_v, sampler=sampler)
    assert removed == 10 and rounds >= 1
    np.testing.assert_array_equal(_dense(out), _dense(g))
    out, removed, _ = eliminate(g, rng.key(3, device="cpu"), 20, o_v=o_v,
                                sampler=sampler)
    assert removed == 20
    assert int((G.degrees(out) == 0).sum()) == 20


def test_rejects_unknown_modes():
    g = _ba(20, 2, 0)
    for kw in ({"o_v": "x"}, {"o_n": "x"}, {"schedule": "x"}):
        with pytest.raises(ValueError):
            _approx(g, 0, 5, **kw)


N, RUNS = 100, 8


def _stats(d):
    return np.linalg.svd(d, compute_uv=False)[0], (d > 0).sum(), d.sum()


@pytest.mark.parametrize("o_v,o_n", [
    ("random", "random"), ("random", "asc"), ("random", "desc"),
    ("degree", "random"), ("coarsen", "random"),
])
@pytest.mark.parametrize("frac", [0.25, 0.5])
def test_spectral_expectation_parity_with_oracle(o_v, o_n, frac):
    """Mean of 8 seeds: max singular value within 25%, edge count and total
    weight within 30% of the sequential C++ oracle's."""
    g = _ba(N, 3, 11)
    m = g.edge_mask
    ei = torch.stack([g.senders[m], g.receivers[m]]).numpy()
    w = g.weights[m].numpy()
    t = int(frac * N)

    def oracle(seed):
        oi, ow = oracle_approximate_cholesky(ei, w, N, t, o_v=o_v, o_n=o_n,
                                             seed=seed)
        d = np.zeros((N, N))
        d[oi[0], oi[1]] = ow
        return _stats(d)

    o_sv, o_edges, o_wt = np.mean([oracle(s) for s in range(RUNS)], axis=0)
    k_sv, k_edges, k_wt = np.mean(
        [_stats(_dense(_approx(g, s, t, o_v=o_v, o_n=o_n)))
         for s in range(RUNS)], axis=0)
    assert abs(k_sv - o_sv) / o_sv < 0.25, (k_sv, o_sv)
    assert abs(k_edges - o_edges) / o_edges < 0.30, (k_edges, o_edges)
    assert abs(k_wt - o_wt) / o_wt < 0.30, (k_wt, o_wt)
