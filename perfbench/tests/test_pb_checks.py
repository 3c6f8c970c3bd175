"""The comparison that decides `correct`, shown to fail: the control (the
reference put in the program's place one precision lower) fails one of
each cell's numbers, and so does each fault the cell can have, planted
underneath a run that otherwise goes as on the chip (only the look for a
card is skipped). The exchange between chips is no fault of these cells:
each runs on one chip."""

import json

import pytest
import torch

from perfbench import calibrate, harness

from .conftest import make_root

SEED = 2 ** 33 + 17


def _limits(root, cell):
    return json.loads((root / "perfbench" / "checks" / f"{cell}.json")
                      .read_text())


def _fails(readings: dict, limits: dict) -> list:
    return [k for k, v in readings.items() if k in limits and v > limits[k]]


@pytest.mark.parametrize("cell", ["grace-arxiv.train", "cca-arxiv.train"])
def test_the_control_fails_a_training_cell(tiny_root, cell):
    rows = calibrate.readings(harness.load_cell(cell, tiny_root), [SEED], 1,
                              torch.device("cpu"))
    limits = _limits(tiny_root, cell)
    assert not _fails(rows[0]["program"], limits)
    assert _fails(rows[0]["control"], limits)


def test_the_control_fails_the_views_cell(tmp_path):
    # a float32 sampler departs from float64 once the running sums are
    # long: 20,000 nodes, m = 5 (at the cell's size it moves 40% of edges)
    root = make_root(tmp_path, {"grace-arxiv": {
        "graph": {"num_nodes": 20000, "m": 5, "num_features": 16},
        "model": {"hidden_dim": 16, "proj_dim": 16}}})
    rows = calibrate.readings(harness.load_cell("grace-arxiv.views", root),
                              [SEED], 1, torch.device("cpu"))
    limits = _limits(root, "grace-arxiv.views")
    assert not _fails(rows[0]["program"], limits)
    assert _fails(rows[0]["control"], limits)


def _still(run):
    """The optimizer's step leaves the state as it was."""
    run.trainer.optimizer.step = lambda *a, **k: None


def _half_grace(run):
    """The loss over the first half of the nodes, the mean over them."""
    tr = run.trainer
    inner = tr.contrast
    n = run.g.num_nodes
    half = torch.arange(n) < n // 2

    def contrast(h1, h2, node_mask=None):
        return inner(h1, h2, node_mask=half)

    tr.contrast = contrast


def _altered_view(run):
    """One edge of every view moved where the augmentor makes it."""
    for rec in run.recipe.recorders:
        aug = rec.fn

        def moved(g, key, aug=aug):
            out = aug(g, key)
            k = int(out.edge_mask.sum()) // 2
            rcv = out.receivers.clone()
            rcv[k] = (rcv[k] + 1) % out.num_nodes
            return out.replace(receivers=rcv)

        rec.fn = moved


def _key_stuck(run):
    """The views' key chain does not advance: every pair repeats."""
    from rlap_tpu_torch.core import rng

    tr = run.trainer
    seed = tr.key.initial_seed()
    inner = tr.views

    def views(g):
        tr.key = rng.key(seed, device=tr.device)
        return inner(g)

    tr.views = views


def _run(root, cell, fault):
    return harness.run(cell, SEED, 3.0, False, root=root, device="cpu",
                       faults=[fault])


@pytest.mark.parametrize("fault", [_still, _half_grace, _altered_view])
def test_each_fault_fails_the_grace_cell(tiny_root, fault):
    out = _run(tiny_root, "grace-arxiv.train", fault)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def _half_cca(monkeypatch):
    from rlap_tpu_torch.models import cca_ssg

    inner = cca_ssg.cca_ssg_loss

    def loss(z1, z2, **kw):
        n = z1.shape[0] // 2
        return inner(z1[:n], z2[:n], **kw)

    monkeypatch.setattr(cca_ssg, "cca_ssg_loss", loss)
    return lambda run: None


@pytest.mark.parametrize("name", ["still", "half", "altered"])
def test_each_fault_fails_the_cca_cell(tiny_root, monkeypatch, name):
    fault = {"still": _still, "altered": _altered_view,
             "half": _half_cca(monkeypatch) if name == "half" else None}[name]
    out = _run(tiny_root, "cca-arxiv.train", fault)
    assert out["correct"] is False


@pytest.mark.parametrize("fault", [_altered_view, _key_stuck])
def test_each_fault_fails_the_views_cell(tiny_root, fault):
    out = _run(tiny_root, "grace-arxiv.views", fault)
    assert out["correct"] is False
    assert out["checks"]["view_diff"]["value"] > 0
