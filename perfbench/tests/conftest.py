"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout, its configurations cut to a size the CPU runs in
seconds. The tests import neither `jax` nor the JAX package."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "grace-arxiv": {"graph": {"num_nodes": 400, "m": 3, "num_features": 16},
                    "model": {"hidden_dim": 16, "proj_dim": 16}},
    "cca-arxiv": {"graph": {"num_nodes": 400, "m": 3, "num_features": 16},
                  "model": {"hidden_dim": 32, "out_dim": 32}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips inside the test "
        "when there is none")


def make_root(tmp: Path, sizes=TINY) -> Path:
    """A checkout holding BENCHMARK.json and a copy of perfbench/ whose
    configurations are cut to `sizes` (every width and count named)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, cut in sizes.items():
        path = tmp / "perfbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        for group, values in cut.items():
            cfg[group].update(values)
        path.write_text(json.dumps(cfg))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
