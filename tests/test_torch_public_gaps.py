"""The package's re-exports of `Graph` and `approximate_cholesky`, which
the JAX package's `rlap_tpu/__init__.py` makes too. The JAX package's
other public options without a caller (`gcn_norm(improved=)`,
`shard_graph(shard_nodes=)`, `native.build(force=)`, the key helpers
`split_like`, `fold` and `KeySeq`) are left out of the port on purpose
(ROADMAP section 1)."""

import pytest
import torch

import rlap_tpu
import rlap_tpu_torch
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.data.synthetic import barabasi_albert as t_ba


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_package_reexports_graph_and_approximate_cholesky():
    from rlap_tpu_torch import Graph, approximate_cholesky
    from rlap_tpu_torch.core.graph import Graph as G
    from rlap_tpu_torch.ops.rlap import approximate_cholesky as ac

    assert Graph is G and approximate_cholesky is ac
    assert {"Graph", "approximate_cholesky"} <= set(vars(rlap_tpu)) & set(
        vars(rlap_tpu_torch))
    g = t_ba(120, 3, seed=2, device="cpu")
    assert isinstance(g, Graph)
    out = approximate_cholesky(g, rng.key(0, device="cpu"), 30,
                               device="cpu")
    live = out.senders[out.edge_mask]
    assert isinstance(out, Graph) and live.numel() > 0
    assert torch.unique(live).numel() <= 90
