"""The port's GRACE trainer and linear probe against the JAX package's, the
GRACE+rLap representation lift, the no-fallback rule, and import hygiene
(the port imports nothing of JAX)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlap_tpu.augment.base import Identity as JIdentity
from rlap_tpu.core.graph import Graph as JGraph
from rlap_tpu.eval import lr_evaluate as j_lr_evaluate
from rlap_tpu.models.grace import GraceTrainer as JTrainer
from rlap_tpu_torch.augment.base import Compose, Identity
from rlap_tpu_torch.augment.feature import FeatureMasking
from rlap_tpu_torch.augment.rlap import PairedRLap, RLap
from rlap_tpu_torch.convert import flax_to_state_dict, load_flax_params
from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.data.synthetic import synthetic_node_dataset
from rlap_tpu_torch.eval.linear_probe import lr_evaluate
from rlap_tpu_torch.eval.split import get_split
from rlap_tpu_torch.models.grace import GraceTrainer

ROOT = Path(__file__).resolve().parents[1]


def _view(n, f, p, seed):
    """A fixed view: an ER graph and features, as numpy arrays."""
    r = np.random.default_rng(seed)
    a = np.triu(r.random((n, n)) < p, 1)
    s, d = np.nonzero(a | a.T)
    return s, d, r.normal(size=(n, f)).astype(np.float32)


def test_three_steps_match_jax():
    """Identical fixed views and parameters: losses and parameters after
    3 Adam steps within rtol 1e-4."""
    n, f, h = 80, 16, 32
    views = [_view(n, f, 0.06, s) for s in (1, 2)]
    jv = [JGraph.from_edges(s, d, n).replace(x=jnp.asarray(x))
          for s, d, x in views]
    tv = [Graph.from_edges(s, d, n, device="cpu").replace(x=torch.tensor(x))
          for s, d, x in views]
    kw = dict(hidden_dim=h, num_layers=2, lr=5e-3, weight_decay=1e-4,
              tau=0.3, block_size=32, loss="infonce_batched")
    jt = JTrainer(JIdentity(), JIdentity(), **kw)
    params = jt.model.init(jax.random.PRNGKey(3), *jv)["params"]
    opt_state = jt.tx.init(params)
    tt = GraceTrainer(Identity(), Identity(), device="cpu", **kw)
    tt.ensure_init(tv[0])
    load_flax_params(tt.model, params)
    for _ in range(3):
        params, opt_state, jloss = jt._step(params, opt_state, *jv)
        tloss = tt.train_step(*tv)
        np.testing.assert_allclose(tloss, float(jloss), rtol=1e-4)
    got = dict(tt.model.named_parameters())
    for name, want in flax_to_state_dict(params).items():
        np.testing.assert_allclose(got[name].detach().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_linear_probe_matches_jax():
    """Same embeddings, split and initial weights: the same metrics."""
    n, f, c = 300, 12, 3
    r = np.random.default_rng(0)
    y = r.integers(0, c, n).astype(np.int32)
    z = (r.normal(size=(c, f))[y] + 1.5 * r.normal(size=(n, f))).astype(
        np.float32)
    split = get_split(n, 0.1, 0.8, seed=0)
    want = j_lr_evaluate(z, y, split, num_classes=c, num_epochs=400)
    lim = np.sqrt(6.0 / (f + c))
    w0 = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (f, c),
                                       jnp.float32, -lim, lim))
    got = lr_evaluate(torch.tensor(z), y, split, num_classes=c,
                      num_epochs=400, init_weight=w0)
    assert set(got) == set(want) == {"micro_f1", "macro_f1", "accuracy"}
    for k in want:
        assert abs(got[k] - want[k]) < 1e-6, (k, got[k], want[k])


def test_grace_rlap_lift_over_raw_features():
    """GRACE with rLap views beats the raw-feature probe by more than 0.1 on
    the weak-feature SBM stand-in (noise 10)."""
    n, c, f = 256, 4, 64
    g, y = synthetic_node_dataset(n=n, num_classes=c, feature_dim=f,
                                  p_in=20.0 / n, p_out=2.0 / n, noise=10.0,
                                  seed=42, device="cpu")
    raw = lr_evaluate(g.x, y, get_split(n, 0.1, 0.8, seed=0), num_classes=c)
    views = [Compose([RLap(0.2, device="cpu"), FeatureMasking(0.3)])
             for _ in range(2)]
    tr = GraceTrainer(*views, hidden_dim=64, num_layers=2, lr=5e-3,
                      block_size=128, seed=0, device="cpu")
    losses = tr.fit(g, max_epochs=60, tolerance=60)
    assert np.isfinite(losses).all()
    res = tr.evaluate(g, y)
    assert res["accuracy"] - raw["accuracy"] > 0.1, (res, raw)


def test_paired_rlap_trains():
    g, y = synthetic_node_dataset(n=128, feature_dim=16, seed=3,
                                  device="cpu")
    tr = GraceTrainer(hidden_dim=16, num_layers=2, lr=5e-3, block_size=64,
                      device="cpu",
                      pair_augmentor=PairedRLap(0.2, pf=0.3, device="cpu"))
    g1, g2 = tr.views(g)
    for view in (g1, g2):
        assert int(((torch.bincount(view.senders[view.edge_mask],
                                    minlength=128)) == 0).sum()) >= 25
        assert bool((view.weights[view.edge_mask] == 1).all())
    losses = tr.fit(g, max_epochs=5, tolerance=5)
    assert np.isfinite(losses).all()


def test_entry_points_default_to_the_card():
    """With no `device`, the trainer and augmentor go to CUDA; without a
    card torch raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises((RuntimeError, AssertionError)):
        GraceTrainer(Identity(), Identity())
    g, _ = synthetic_node_dataset(n=32, feature_dim=4, device="cpu")
    from rlap_tpu_torch.core import rng
    with pytest.raises((RuntimeError, AssertionError)):
        RLap(0.2)(g, rng.key(0, device="cpu"))
    with pytest.raises((RuntimeError, AssertionError)):
        rng.key(0)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import rlap_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(rlap_tpu_torch.__path__,"
        " 'rlap_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'optax', 'rlap_tpu')]\n"
        "port = [m for m in sys.modules if m.startswith('rlap_tpu_torch')]\n"
        "print(bad, len(port))\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[-1]) >= 20  # every module was imported
