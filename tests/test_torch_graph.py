"""The port's graph algebra and synthetic generators against the JAX
package's, exactly: the same numpy inputs must give the same arrays.

Edge weights are multiples of 1/2, so every sum of them is exact in float32
whatever order the two packages add in.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlap_tpu.core import graph as JG
from rlap_tpu.data import synthetic as JS
from rlap_tpu_torch.core import graph as TG
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.data import synthetic as TS


def _same(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.detach().cpu().numpy())


def _same_graph(jg, tg):
    assert jg.num_nodes == tg.num_nodes
    _same(jg.senders, tg.senders)
    _same(jg.receivers, tg.receivers)
    _same(jg.weights, tg.weights)
    if jg.x is not None:
        _same(jg.x, tg.x)


def _messy_edges(n=40, e=300, cap=512, seed=0):
    """Duplicates, self-loops and zero weights, padded to `cap`."""
    r = np.random.default_rng(seed)
    s = r.integers(0, n, e)
    d = r.integers(0, n, e)
    w = r.integers(0, 4, e) / 2.0
    return (JG.Graph.from_edges(s, d, n, weights=w, edge_capacity=cap),
            TG.Graph.from_edges(s, d, n, weights=w, edge_capacity=cap,
                                device="cpu"))


_OPS = {
    "sort_edges": (JG.sort_edges, TG.sort_edges),
    "coalesce_sum": (JG.coalesce, TG.coalesce),
    "coalesce_max": (lambda g: JG.coalesce(g, reduce="max"),
                     lambda g: TG.coalesce(g, reduce="max")),
    "coalesce_fast": (JG.coalesce_fast, TG.coalesce_fast),
    "drop_zero_weight": (JG.drop_zero_weight, TG.drop_zero_weight),
    "remove_self_loops": (JG.remove_self_loops, TG.remove_self_loops),
    "add_self_loops": (lambda g: JG.add_self_loops(g, 2.0),
                       lambda g: TG.add_self_loops(g, 2.0)),
    "with_capacity_grow": (lambda g: JG.with_capacity(g, 640),
                           lambda g: TG.with_capacity(g, 640)),
    "with_capacity_shrink": (
        lambda g: JG.with_capacity(JG.coalesce(g), 400),
        lambda g: TG.with_capacity(TG.coalesce(g), 400)),
}


@pytest.mark.parametrize("op", sorted(_OPS))
def test_edge_ops_equal_jax(op):
    jg, tg = _messy_edges(seed=len(op))
    fj, ft = _OPS[op]
    _same_graph(fj(jg), ft(tg))


_NODE_OPS = {
    "degrees": (JG.degrees, TG.degrees),
    "weighted_degrees": (JG.weighted_degrees, TG.weighted_degrees),
    "to_dense": (JG.to_dense, TG.to_dense),
    "laplacian_dense": (JG.laplacian_dense, TG.laplacian_dense),
}


@pytest.mark.parametrize("op", sorted(_NODE_OPS))
def test_node_ops_equal_jax(op):
    jg, tg = _messy_edges(seed=7)
    fj, ft = _NODE_OPS[op]
    _same(fj(jg), ft(tg))


def test_add_self_loops_respects_node_mask():
    jg, tg = _messy_edges(seed=3)
    mask = np.arange(40) % 3 != 0
    jg = jg.replace(node_mask=jnp.asarray(mask))
    tg = tg.replace(node_mask=torch.as_tensor(mask))
    _same_graph(JG.add_self_loops(jg), TG.add_self_loops(tg))
    assert int(tg.num_real_nodes) == int(jg.num_real_nodes)
    assert int(tg.num_edges) == int(jg.num_edges)


@pytest.mark.parametrize("gen", ["ba", "er", "sbm", "node_dataset"])
def test_generators_equal_jax(gen):
    if gen == "ba":
        _same_graph(JS.barabasi_albert(150, 3, seed=5),
                    TS.barabasi_albert(150, 3, seed=5, device="cpu"))
    elif gen == "er":
        _same_graph(JS.erdos_renyi(90, 0.08, seed=2),
                    TS.erdos_renyi(90, 0.08, seed=2, device="cpu"))
    elif gen == "sbm":
        (jg, jl), (tg, tl) = (JS.sbm(120, 3, 0.1, 0.01, seed=4),
                              TS.sbm(120, 3, 0.1, 0.01, seed=4, device="cpu"))
        _same_graph(jg, tg)
        np.testing.assert_array_equal(jl, tl)
    else:
        (jg, jl), (tg, tl) = (
            JS.synthetic_node_dataset(n=100, feature_dim=16, seed=1),
            TS.synthetic_node_dataset(n=100, feature_dim=16, seed=1,
                                      device="cpu"))
        _same_graph(jg, tg)
        np.testing.assert_array_equal(jl, tl)


def test_rng_keys_are_pure_and_distinct():
    k = rng.key(11, device="cpu")
    a = rng.fold_in(k, 3)
    torch.rand(5, generator=k)  # drawing from the parent changes nothing
    b = rng.fold_in(k, 3)
    assert a.initial_seed() == b.initial_seed()
    seeds = {rng.fold_in(k, i).initial_seed() for i in range(4)}
    seeds |= {c.initial_seed() for c in rng.split(k, 4)}
    assert len(seeds) == 8
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
