"""The modules that a single-card run and the recipe CLI import load no part
of the sharded layer: `rlap_tpu_torch.parallel.mesh` and the
`torch.distributed.tensor` it imports are loaded only where a `mesh` is
passed. Each module is imported in a fresh interpreter, so that no other
test's imports are in `sys.modules`."""

import subprocess
import sys

import pytest

SHARDED = ("torch.distributed.tensor", "rlap_tpu_torch.parallel.mesh")


@pytest.mark.parametrize("module", [
    "rlap_tpu_torch", "rlap_tpu_torch.core.graph", "rlap_tpu_torch.ops.spmm",
    "rlap_tpu_torch.ops.rlap", "rlap_tpu_torch.nn.gcn",
    "rlap_tpu_torch.nn.gin", "rlap_tpu_torch.augment",
    "rlap_tpu_torch.models.grace", "rlap_tpu_torch.models.cca_ssg",
    "rlap_tpu_torch.models.mvgrl", "rlap_tpu_torch.models.graphcl",
    "rlap_tpu_torch.models.bgrl", "rlap_tpu_torch.cli.run"])
def test_single_card_modules_leave_the_sharded_layer_unloaded(module):
    code = (f"import sys, {module}\n"
            f"print(*[m for m in {SHARDED!r} if m in sys.modules])")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", (
        f"importing {module} loads {res.stdout.strip()}")
