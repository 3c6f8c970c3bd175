"""The graph kinds, found by name under `graphs/`: BA's senders,
receivers, weights and features pinned bit for bit (hashes taken before
the generator moved there), and an unknown kind refused."""

import hashlib

import pytest

from perfbench import graphgen


def _hash(t) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("n, m, f, seed, want", [
    (300, 3, 8, 7, ("b7d19ab0d64b1163", "f3885151049da88a",
                    "870dae8ff1a85692", "50352e704382a100")),
    (300, 3, 8, 2 ** 33 + 17, ("5ca8b2fed929d6f9", "bcdfbf77ef59fba0",
                               "19f653aecfb8e394", "e144306d9e932bc3")),
    (1000, 5, 16, 7, ("8b6bbc72318b82db", "d3e394c9784db9af",
                      "6cfdc71487e4914d", "967fd5055a092a57")),
    (1000, 5, 16, 2 ** 33 + 17, ("fd1dfff626fa2ce8", "b5a0da5b60b61ab5",
                                 "5d352ad6006a6f4b", "d6d82435157cc627")),
])
def test_barabasi_albert_is_pinned(n, m, f, seed, want):
    g = graphgen.make_graph({"kind": "barabasi_albert", "num_nodes": n,
                             "m": m, "num_features": f}, seed, "cpu")
    assert g.num_nodes == n
    assert tuple(_hash(t) for t in (g.senders, g.receivers, g.weights,
                                    g.x)) == want


def test_an_unknown_kind_is_refused():
    with pytest.raises(ValueError, match="unknown graph kind"):
        graphgen.make_graph({"kind": "erdos_renyi"}, 1, "cpu")
