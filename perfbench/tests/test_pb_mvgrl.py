"""The MVGRL cell on the CPU at a small size: its graph kind pinned and of
the exact edge count; a sound run `correct`; the control (the reference
one precision lower: the rLap sampler in float32, the series and the
training steps with TF32 products) failing a limit of
`checks/mvgrl-pubmed.train.json`; and each fault the cell can have,
planted underneath a run that otherwise goes as on the chip, failing
one."""

import hashlib
import json

import pytest
import torch

from perfbench import calibrate, graphgen, harness

from .conftest import make_root

CELL = "mvgrl-pubmed.train"
SEED = 2 ** 33 + 17
SMALL = {"mvgrl-pubmed": {
    "graph": {"num_nodes": 400, "num_edges": 900, "num_features": 16},
    "model": {"hidden_dim": 16}, "views": {"subsample": 64}}}


@pytest.fixture
def small_root(tmp_path):
    return make_root(tmp_path, SMALL)


def _hash(t) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()[:16]


def _spec(n, e, m=2, f=8):
    return {"kind": "preferential_attachment", "num_nodes": n,
            "num_edges": e, "m": m, "num_features": f}


def test_preferential_attachment_is_pinned():
    g = graphgen.make_graph(_spec(300, 700), 7, "cpu")
    assert tuple(_hash(t) for t in (g.senders, g.receivers, g.weights,
                                    g.x)) == (
        "31d0360b0f027648", "f5056ad22adeea80", "288ffe7d2fb798c1",
        "50352e704382a100")


@pytest.mark.parametrize("n, e, m", [(19717, 44324, 2), (300, 597, 2),
                                     (300, 894, 2), (50, 170, 3)])
def test_preferential_attachment_has_the_exact_edge_count(n, e, m):
    g = graphgen.make_graph(_spec(n, e, m), SEED, "cpu")
    live = g.edge_mask
    s, r = g.senders[live], g.receivers[live]
    assert s.numel() == 2 * e
    assert torch.unique(s * n + r).numel() == 2 * e
    assert bool((s != r).all())
    assert torch.equal(torch.sort(s * n + r).values, s * n + r)
    assert torch.equal(torch.sort(r * n + s).values, s * n + r)
    assert int(torch.bincount(s, minlength=n).min()) >= m
    assert g.edge_capacity % 128 == 0 and g.x.shape == (n, 8)


@pytest.mark.parametrize("e", [596, 895])
def test_an_edge_count_out_of_reach_is_refused(e):
    with pytest.raises(ValueError, match="out of reach"):
        graphgen.make_graph(_spec(300, e), SEED, "cpu")


def test_a_sound_run_is_correct_and_the_control_is_not(small_root):
    rows = calibrate.readings(harness.load_cell(CELL, small_root), [SEED], 1,
                              torch.device("cpu"))
    limits = json.loads((small_root / "perfbench" / "checks" /
                         f"{CELL}.json").read_text())
    assert all(v <= limits[k] for k, v in rows[0]["program"].items())
    assert any(v > limits[k] for k, v in rows[0]["control"].items())


def _cache(run):
    return run.trainer.aug2.fn.augmentors[0]


def moved_edge(run):
    """One edge of each fresh diffusion view moved to the next node."""
    cache = _cache(run)
    inner = cache.inner

    def made(g, key):
        out = inner(g, key)
        k = int(out.edge_mask.sum()) // 2
        rcv = out.receivers.clone()
        rcv[k] = (rcv[k] + 1) % out.num_nodes
        return out.replace(receivers=rcv)

    cache.inner = made


def steps_31(run):
    """The PPR series cut one step short."""
    run.recipe.diffusion.iters = 31


def alpha_021(run):
    """The teleport probability 0.21 in place of 0.2."""
    run.recipe.diffusion.alpha = 0.21


def fresh_when_cached(run):
    """A fresh diffusion view on every call."""
    _cache(run).refresh_every = 1


def swapped_mask(run, monkeypatch):
    """The subsample drawn from 1 - u: another mask of the same size."""
    from rlap_tpu_torch.models import mvgrl

    inner = mvgrl.subsample_mask
    monkeypatch.setattr(mvgrl, "subsample_mask",
                        lambda g2, u, size: inner(g2, 1 - u, size))


def still(run):
    """The optimizer's step leaves the state as it was."""
    run.trainer.optimizer.step = lambda *a, **k: None


FAULTS = [moved_edge, steps_31, alpha_021, fresh_when_cached, swapped_mask,
          still]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_each_fault_fails_a_limit(small_root, monkeypatch, fault):
    def plant(run):
        if fault is swapped_mask:
            fault(run, monkeypatch)
        else:
            fault(run)

    out = harness.run(CELL, SEED, 0.5, False, root=small_root, device="cpu",
                      faults=[plant])
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
