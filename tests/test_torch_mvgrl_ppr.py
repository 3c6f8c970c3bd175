"""MVGRL with rLap-then-PPR views against the benchmark's plain
reference (`perfbench/reference/`), which imports no JAX: the PPR series
on a sparse T against the dense arithmetic it replaced (rtol 1e-5), the
diffusion view against `reference/ppr.py`, and three `MVGRLTrainer` steps
against `reference/mvgrl.py`."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import harness
from perfbench.recipes import mvgrl as recipe_mvgrl
from perfbench.reference import ppr as ref_ppr
from rlap_tpu_torch.augment import diffusion as D
from rlap_tpu_torch.augment.rlap import RLap
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.data.synthetic import barabasi_albert

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(kind: str) -> G.Graph:
    """A BA graph; or a directed weighted one with repeated edges, self-
    loops (one of them twice) and padding."""
    if kind == "ba":
        return barabasi_albert(60, 3, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(5)
    n, e = 40, 200
    s = torch.randint(0, n, (e,), generator=gen)
    r = torch.randint(0, n, (e,), generator=gen)
    s[:6] = r[:6] = torch.tensor([0, 1, 2, 3, 3, 7])
    s[6:12], r[6:12] = s[12:18], r[12:18]
    w = torch.rand(e, generator=gen) + 0.5
    pad = torch.full((24,), n)
    return G.Graph(senders=torch.cat([s, pad]), receivers=torch.cat([r, pad]),
                   weights=torch.cat([w, torch.zeros(24)]), num_nodes=n)


def _dense_series(g, alpha, iters, loops):
    """The arithmetic the series took before: dense T, dense products."""
    t = D._sym_norm_dense(g, loops)
    eye = torch.eye(g.num_nodes)
    s = alpha * eye
    for _ in range(iters):
        s = alpha * eye + (1 - alpha) * (t @ s)
    return s


@pytest.mark.parametrize("loops", [True, False], ids=["loops", "no_loops"])
@pytest.mark.parametrize("kind", ["ba", "directed"])
def test_ppr_series_on_sparse_t_matches_the_dense_arithmetic(kind, loops):
    g = _graph(kind)
    for alpha, iters in ((0.2, 32), (0.15, 7)):
        torch.testing.assert_close(
            D.compute_ppr_dense(g, alpha, iters, add_self_loop=loops),
            _dense_series(g, alpha, iters, loops), rtol=1e-5, atol=1e-7)


def test_sparse_t_holds_the_dense_t_entries():
    """A + I adds one to a self-loop present; repeated edges sum."""
    g = _graph("directed")
    for loops in (True, False):
        t = D._sym_norm_sparse(g, loops)
        dense = torch.zeros(g.num_nodes, g.num_nodes)
        dense[t.receivers, t.senders] = t.weights
        torch.testing.assert_close(dense, D._sym_norm_dense(g, loops),
                                   rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_diffusion_view_matches_the_plain_reference(seed):
    """The Schur complement edge for edge and weight for weight, and the
    top-k view of S against the float64 S of that complement."""
    g = barabasi_albert(300, 3, seed=seed % 97, device="cpu")
    gd = harness.graph_dict(g)
    ref_keys, ref_w = ref_ppr.schur_complement(gd, seed, 0.2)
    # a key is a stream: each call draws from a fresh one of the seed
    sc = RLap(0.2, keep_weights=True, device="cpu")(g, rng.key(seed, "cpu"))
    live = sc.edge_mask
    mine = sc.senders[live] * (g.num_nodes + 1) + sc.receivers[live]
    order = torch.argsort(mine)
    assert torch.equal(mine[order], ref_keys)
    torch.testing.assert_close(sc.weights[live][order].double(), ref_w,
                               rtol=1e-6, atol=0.0)
    view = D.RLapPPRDiffusion(0.2, device="cpu")(g, rng.key(seed, "cpu"))
    n, k = g.num_nodes, g.edge_capacity // g.num_nodes
    s64 = ref_ppr.ppr(sc.senders[live], sc.receivers[live], sc.weights[live],
                      n, 0.2, 32)
    vl = view.edge_mask
    gap, wrong = ref_ppr.view_gaps(s64, view.senders[vl], view.receivers[vl],
                                   view.weights[vl], k, 1e-4, 1e-4)
    assert wrong == 0
    assert gap < 1e-5
    # the reference's own view is the program's, entry for entry
    rows, cols, _ = ref_ppr.top_k(s64, k, 1e-4)
    assert torch.equal(torch.sort(rows * n + cols).values,
                       view.senders[vl] * n + view.receivers[vl])


def test_three_mvgrl_steps_match_the_plain_reference():
    """n = 300, subsample 64, seeded weights: the losses, the first
    gradient as Adam takes it and each parameter's change over the three
    steps, leaf by leaf."""
    cfg = json.loads((ROOT / "perfbench" / "configs" / "mvgrl-pubmed.json")
                     .read_text())
    cfg["graph"].update(num_nodes=300, num_edges=700, num_features=16)
    cfg["model"].update(hidden_dim=16)
    cfg["views"].update(subsample=64)
    dev = torch.device("cpu")
    g = harness.graphgen.make_graph(cfg["graph"], 11, dev)
    rec = recipe_mvgrl.Recipe(cfg, dev)
    w0 = rec.init_weights(torch.Generator().manual_seed(4))
    tr = rec.build(g, w0, 12)
    params = dict(tr.model.named_parameters())
    p0 = {k: v.detach().clone() for k, v in params.items()}
    log = []
    harness.arm(rec.recorders, log)
    losses = [tr.train_epoch(g)]
    grad = {k: tr.optimizer.state[p]["exp_avg"] / 0.1
            for k, p in params.items()}
    losses += [tr.train_epoch(g) for _ in range(2)]
    harness.arm(rec.recorders, None)
    assert rec.view_gap(g, log) < 1e-5
    assert sum(int(m.sum()) >= 64 and int(m.sum()) < 300
               for m, _ in (e.value for e in log if e.what == "mask")) == 3
    ref_losses, ref_grad, ref_p = rec.reference_train(w0, g, log)
    torch.testing.assert_close(torch.tensor(losses), torch.tensor(ref_losses),
                               rtol=1e-5, atol=0.0)
    for k in params:
        torch.testing.assert_close(grad[k], ref_grad[k], rtol=1e-4,
                                   atol=1e-7, msg=k)
        torch.testing.assert_close(params[k].detach() - p0[k],
                                   ref_p[k] - w0[k], rtol=1e-3, atol=1e-7,
                                   msg=k)
