"""On the card: one short run of each cell through the command, correct
and of the contract's shape. Skips inside the test where there is no
card: `python -m pytest perfbench/tests/test_pb_chip.py -q` there."""

import json
import subprocess
import sys

import pytest

from .conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["grace-arxiv.train", "cca-arxiv.train",
                                  "grace-arxiv.views"])
def test_a_short_run_on_the_card_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          cell, "--seed", str(2 ** 31 + 99), "--seconds",
                          "3", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
