"""The harness on the CPU at a tiny size: the result line's shape, the
traced line, a cell and a metric added as new files only, the exit
without a card, and the check that no module of JAX or of the JAX package
is loaded."""

import json
import subprocess
import sys

import pytest

from perfbench import harness

from .conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", ["grace-arxiv.train", "cca-arxiv.train",
                                  "grace-arxiv.views"])
def test_tiny_run_prints_a_line_of_the_contract(tiny_root, cell):
    out = harness.run(cell, 2 ** 33 + 5, 3.0, False, root=tiny_root,
                      device="cpu")
    assert list(out) == KEYS           # `checks` last
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wanted = {m["name"] for m in bench["end_to_end"]
              if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == wanted
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(out)


def test_traced_run_adds_the_window_and_a_breakdown(tiny_root):
    out = harness.run("grace-arxiv.train", 11, 2.0, True, root=tiny_root,
                      device="cpu")
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10
    # the CPU has no device trace: the shares of a peak stay silent
    assert "step_mfu" not in out["metrics"]
    assert out["metrics"]["views_ms.train"]["value"] > 0


def test_a_cell_and_a_metric_added_as_files_only(tiny_root):
    pb = tiny_root / "perfbench"
    cfg = json.loads((pb / "configs" / "grace-arxiv.json").read_text())
    cfg["name"] = "grace-small"
    cfg["graph"]["num_nodes"] = 300
    (pb / "configs" / "grace-small.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "train-short.json").write_text(json.dumps(
        {"drive": "train_epoch", "check_steps": 2, "profile_units": 1}))
    (pb / "checks" / "grace-small.train-short.json").write_text(
        (pb / "checks" / "grace-arxiv.train.json").read_text())
    (pb / "metrics" / "steps_done.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "grace-small", "source": "a test",
                             "file": "perfbench/configs/grace-small.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "grace-small.train-short",
                               "config": "grace-small",
                               "traffic": "train-short", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "steps_done", "unit": "steps",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["grace-small.train-short"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = harness.run("grace-small.train-short", 3, 1.0, False,
                      root=tiny_root, device="cpu")
    assert out["correct"] is True
    assert out["metrics"]["steps_done"]["value"] == out["attempted"]
    assert "train_step_ms" not in out["metrics"]


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    if _has_card():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "grace-arxiv.views", "--seed", str(2 ** 33),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""


def _has_card() -> bool:
    import torch

    return torch.cuda.is_available()


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["rlap_tpu_torch", "rlap_tpu_torch.ops.rlap", "jaxtyping", "flaxen",
         "torch"]) == []
    assert harness.forbidden_modules(
        ["rlap_tpu.ops.rlap", "jaxlib.xla", "jax", "flax.linen",
         "rlap_tpu_torch"]) == ["flax", "jax", "jaxlib", "rlap_tpu"]


def test_a_run_loads_no_module_of_jax_or_the_jax_package(tiny_root):
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from perfbench import harness\n"
        "out = harness.run('grace-arxiv.train', 7, 1.0, True, "
        "root=Path(%r), device='cpu')\n"
        "tops = sorted({n.split('.')[0] for n in sys.modules})\n"
        "print(json.dumps([out['correct'], tops]))\n"
    ) % (str(ROOT), str(tiny_root))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    correct, tops = json.loads(res.stdout.strip().splitlines()[-1])
    assert correct is True
    assert "rlap_tpu_torch" in tops
    assert not set(tops) & {"jax", "jaxlib", "flax", "rlap_tpu"}
