"""The port's measurement entry points on the CPU: the augmentor bench
(`rlap_tpu_torch.bench.augmentors`) with the JAX package's result keys,
the rLap throughput bench (`python -m rlap_tpu_torch.bench.rlap_throughput`)
with `bench.py`'s JSON keys, and the GRACE epoch bench
(`rlap_tpu_torch.bench.epoch`) with the keys of `tools/bench_epoch.py`'s
record. On the CPU their times say nothing about the card; these tests
hold what they compute and check, not how fast."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from rlap_tpu_torch.bench import augmentors as AB
from rlap_tpu_torch.bench import epoch as EB
from rlap_tpu_torch.data.synthetic import barabasi_albert
from rlap_tpu_torch.utils.logging import MetricsLogger, read_metrics

ROOT = Path(__file__).resolve().parents[1]
# rlap_tpu/bench/augmentors.py:71-76 and, where no memory analysis is
# possible, :44-50
AUG_KEYS = {"latency_ms_mean", "latency_ms_std", "edges_per_s",
            "mem_delta_bytes", "peak_hbm_bytes", "hbm_note"}
# bench.py's JSON line
THROUGHPUT_KEYS = {"metric", "value", "unit", "vs_baseline"}
# EPOCH_BENCH.json, written by tools/bench_epoch.py
EPOCH_KEYS = set(json.loads((ROOT / "EPOCH_BENCH.json").read_text()))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of a thread per core in each of them makes every
    small op wait on threads that are not scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with_x(g, f=8, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return g.replace(x=torch.randn(g.num_nodes, f, generator=gen))


def test_bench_all_node_and_graph_level(tmp_path):
    g = _with_x(barabasi_albert(200, 3, seed=0, device="cpu"))
    graphs = [_with_x(barabasi_albert(30 + 5 * i, 2, seed=i, device="cpu"),
                      seed=i) for i in range(4)]
    names = ("rLap", "EdgeDropping", "NodeDropping")
    log = tmp_path / "bench.jsonl"
    res = AB.bench_all(g, names, repeats=2, graphs=graphs,
                       logger=MetricsLogger(str(log), echo=False))
    assert sorted(res) == sorted(names + tuple(n + "/batch" for n in names))
    for name, r in res.items():
        assert set(r) == AUG_KEYS, name
        assert r["latency_ms_mean"] > 0 and r["latency_ms_std"] >= 0
        assert r["edges_per_s"] > 0
        assert r["mem_delta_bytes"] is None and r["peak_hbm_bytes"] is None
        assert r["hbm_note"] == AB.CPU_NOTE
    recs = list(read_metrics(str(log), "augmentor_bench"))
    assert [(r["augmentor"], r["level"]) for r in recs] == [
        (n, lvl) for n in names for lvl in ("node", "graph")]
    assert all(set(r) >= AUG_KEYS for r in recs)


def test_bench_augmentor_counts_the_graphs_edges():
    g = _with_x(barabasi_albert(100, 2, seed=1, device="cpu"))

    class Fixed:
        """Returns its input: latency is the harness's own."""
        calls = 0

        def __call__(self, graph, key):
            Fixed.calls += 1
            assert key.device == graph.device
            return graph

    r = AB.bench_augmentor(Fixed(), g, repeats=3)
    assert Fixed.calls == 1 + 3  # one warm-up, three timed
    e = int(g.num_edges)
    assert r["edges_per_s"] == pytest.approx(
        e / (r["latency_ms_mean"] / 1e3))


def test_rlap_throughput_entry_point_on_the_cpu(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "rlap_tpu_torch.bench.rlap_throughput",
         "2000", "--device", "cpu", "--reps", "2"], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(out) >= THROUGHPUT_KEYS | {"ms_per_call", "rounds", "removed",
                                          "oracle_s", "device"}
    assert out["metric"] == "rlap_edges_per_s" and out["unit"] == "edges/s"
    assert out["removed"] == 1000 and out["device"] == "cpu"
    assert len(out["oracle_s"]) == 5 and len(out["rounds"]) == 2
    assert out["value"] == pytest.approx(out["directed_edges"]
                                         / (out["ms_per_call"] / 1e3))
    assert out["vs_baseline"] == pytest.approx(
        out["value"] / out["oracle_edges_per_s"])
    assert "oracle" in res.stderr  # diagnostics go to stderr
    assert os.listdir(tmp_path) == []


def test_epoch_bench_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = EB.run(n=300, epochs=1, device="cpu")
    assert set(res) >= EPOCH_KEYS
    assert res["n"] == 300 and res["directed_edges"] > 0
    assert res["epochs_timed"] == 1 and res["device"] == "cpu"
    for v in ("separate", "paired"):
        assert res[f"first_epoch_ms_{v}"] > 0
        assert len(res[f"epochs_ms_{v}"]) == 1
        # the plain InfoNCE runs on the CPU: no kernel launch
        assert set(res[f"infonce_launches_{v}"].values()) == {0}
    assert res["removed_per_view"] == 60
    assert res["views_checked"] == 4 * (2 * 1 + 1)
    assert res["reference_augmentation_floor_ms"] == pytest.approx(
        2 * res["cpu_oracle_view_ms"])
    assert os.listdir(tmp_path) == []  # no file without `out`
    out = tmp_path / "epoch.json"
    EB.run(n=200, epochs=1, device="cpu", out=str(out))
    assert set(json.loads(out.read_text())) >= EPOCH_KEYS
