"""The recipe contract on the CPU, with a stub recipe (`toy_recipe.py`)
and a toy program (`toy_program.py`) of the tests' own: views whose
weights are not 1 from a small dense diffusion, a view cached across
steps while the key chain advances, and a recorded permutation that the
reference needs. The sound toy reads `correct`; each planted fault fails
its number."""

import json
import shutil
from pathlib import Path

import pytest

from perfbench import harness

from .conftest import make_root

CELL = "toy-diff.train"
SEED = 2 ** 33 + 29
# the sound toy reads view_diff 1.0-1.2e-6 and the other gaps under 3e-7
# on four seeds; every planted fault reads 0.5 or more in its number
LIMITS = {"view_diff": 1e-5, "loss_gap": 1e-5, "grad_gap": 1e-4,
          "change_gap": 1e-3}


@pytest.fixture
def stub_root(tmp_path):
    root = make_root(tmp_path)
    pb = root / "perfbench"
    shutil.copy(Path(__file__).parent / "toy_recipe.py",
                pb / "recipes" / "toy_diffusion.py")
    (pb / "configs" / "toy-diff.json").write_text(json.dumps({
        "name": "toy-diff", "recipe": "toy_diffusion",
        "graph": {"kind": "barabasi_albert", "num_nodes": 60, "m": 3,
                  "num_features": 8},
        "model": {"hidden_dim": 16, "lr": 0.01},
        "views": {"alpha": 0.2, "drop": 0.2, "refresh_every": 2}}))
    (pb / "checks" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-diff", "source": "a test",
                             "file": "perfbench/configs/toy-diff.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "toy-diff",
                               "traffic": "train", "chips": 1,
                               "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, fault=lambda run: None):
    runs = []

    def keep(run):
        runs.append(run)
        fault(run)

    out = harness.run(CELL, SEED, 1.0, False, root=root, device="cpu",
                      faults=[keep])
    return out, runs[0]


def test_the_toy_program_reads_correct(stub_root):
    out, run = _run(stub_root)
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == set(LIMITS)
    views = [e for e in run.record if e.what == "view"]
    perms = [e for e in run.record if e.what == "perm"]
    # three checked steps: fresh, cached, fresh; the keys all differ
    assert [e.cached for e in views] == [False, True, False]
    assert len({e.key for e in views}) == 3 and len(perms) == 3
    assert all(t.device.type == "cpu" for e in views
               for t in e.value.values() if hasattr(t, "device"))
    assert not bool((views[0].value["weights"] == 1).all())


def _cache(run):
    """The program's `CachedAugmentor` behind the view recorder."""
    return run.recipe.recorders[0].fn


def _weight_moved_in_cache(run):
    """A call that returns the cache returns it with one weight moved."""
    cache = _cache(run)
    inner = cache.augment

    def augment(g, key):
        before = cache._cache
        out = inner(g, key)
        if out is not before:
            return out
        w = out.weights.clone()
        k = int(w.abs().argmax())
        w[k] = w[k] * 1.5
        return out.replace(weights=w)

    cache.augment = augment


def _fresh_for_cached(run):
    """Every call makes a fresh view where the cache was due."""
    _cache(run).refresh_every = 1


def _perm_swapped_where_drawn(run):
    """The draw returns another permutation than its key gives."""
    rec = run.recipe.recorders[1]
    inner = rec.fn
    rec.fn = lambda n: inner(n).roll(1)


def _perm_swapped_where_used(run):
    """The step corrupts with another permutation than the one drawn."""
    tr = run.trainer
    drawn = tr.corruption
    tr.corruption = lambda n: drawn(n).flip(0)


@pytest.mark.parametrize("fault, number", [
    (_weight_moved_in_cache, "view_diff"),
    (_fresh_for_cached, "view_diff"),
    (_perm_swapped_where_drawn, "view_diff"),
    (_perm_swapped_where_used, "loss_gap"),
])
def test_each_fault_fails_its_number(stub_root, fault, number):
    out, _ = _run(stub_root, fault)
    assert out["correct"] is False
    c = out["checks"][number]
    assert isinstance(c["value"], str) or c["value"] > c["limit"], c


def test_the_harness_knows_nothing_of_a_recipes_check():
    src = (Path(harness.__file__)).read_text()
    assert "perfbench.reference" not in src
    for attr in (".frac", ".pf", ".plumbing"):
        assert attr not in src
