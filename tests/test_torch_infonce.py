"""The port's InfoNCE against the JAX package's: `infonce_batched`, and the
fused path (JAX's Pallas kernel in interpret mode; the port's kernel
wrappers run their plain versions on CPU tensors). Values within rtol 1e-5,
gradients within rtol 1e-4, both in float32. The CUDA kernels themselves
are held against their plain versions in `test_torch_kernels.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlap_tpu.objectives import contrast as JC
from rlap_tpu.ops.infonce_pallas import infonce_fused as j_fused
from rlap_tpu_torch.objectives import contrast as TC
from rlap_tpu_torch.ops import infonce_fused as K


def _data(n=200, f=24, seed=0):
    r = np.random.default_rng(seed)
    a = r.normal(size=(n, f)).astype(np.float32)
    b = r.normal(size=(n, f)).astype(np.float32)
    mask = r.random(n) < 0.85
    return a, b, mask


def _t(x, grad=False):
    return torch.tensor(x, requires_grad=grad)


def _close(got, ref, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("mask_on", [False, True])
@pytest.mark.parametrize("n,f", [(200, 24), (133, 10)])
def test_batched_matches_jax(mask_on, n, f):
    a, b, mask = _data(n, f, seed=n)
    m = mask if mask_on else None
    ref = JC.infonce_batched(jnp.asarray(a), jnp.asarray(b), tau=0.2,
                             block_size=64,
                             anchor_mask=None if m is None else jnp.asarray(m))
    got = TC.infonce_batched(_t(a), _t(b), tau=0.2, block_size=64,
                             anchor_mask=None if m is None else _t(m))
    _close(got, ref, 1e-5, 1e-5)


@pytest.mark.parametrize("port", ["fused", "fused_plain"])
@pytest.mark.parametrize("mask_on", [False, True])
@pytest.mark.parametrize("n,f,tau", [(160, 16, 0.5), (133, 10, 0.2)])
def test_fused_value_and_grads_match_jax(port, mask_on, n, f, tau):
    a, b, mask = _data(n, f, seed=3 + n)
    jm = jnp.asarray(mask) if mask_on else None

    def jloss(x, y):
        return j_fused(x, y, tau=tau, anchor_mask=jm, block_m=128,
                       block_n=128)

    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(a),
                                                      jnp.asarray(b))
    fn = K.infonce_fused if port == "fused" else K.infonce_fused_plain
    ta, tb = _t(a, True), _t(b, True)
    tv = fn(ta, tb, tau=tau, anchor_mask=_t(mask) if mask_on else None)
    tv.backward()
    _close(tv, jv, 1e-5, 1e-5)
    _close(ta.grad, jg[0], 1e-4, 1e-7)
    _close(tb.grad, jg[1], 1e-4, 1e-7)


def test_kernel_wrappers_match_autograd_on_cpu():
    """The backward wrappers' plain versions equal autograd through the
    plain forward (each kernel's function, checked on its own)."""
    a, b, _ = _data(150, 20, seed=5)
    a = K.l2norm(_t(a)).detach().requires_grad_(True)
    b = K.l2norm(_t(b)).detach().requires_grad_(True)
    g = torch.linspace(-1.0, 1.0, 150)
    before = dict(K.launch_counts)
    out, lse = K.infonce_fwd_plain(a, b, 0.3, block=64)
    (out * g).sum().backward()
    o2, l2 = K.infonce_fwd(a.detach(), b.detach(), 0.3)
    torch.testing.assert_close(o2, out.detach(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(l2, lse.detach(), rtol=1e-5, atol=1e-6)
    da = K.infonce_bwd_da(a.detach(), b.detach(), l2, g, 0.3)
    db = K.infonce_bwd_db(a.detach(), b.detach(), l2, g, 0.3)
    torch.testing.assert_close(da, a.grad, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(db, b.grad, rtol=1e-4, atol=1e-6)
    assert K.launch_counts == before  # no kernel runs for CPU tensors


@pytest.mark.parametrize("loss,jax_loss", [
    ("infonce", "infonce"),  # masks columns too, unlike the others
    ("infonce_batched", "infonce_batched"),
    ("infonce_fused", "infonce_fused"),
    ("auto", "infonce_batched"),
])
def test_dual_branch_routes_match_jax(loss, jax_loss):
    a, b, mask = _data(96, 8, seed=7)
    ref = JC.DualBranchContrast(loss=jax_loss, mode="L2L", tau=0.2,
                                block_size=32)(h1=jnp.asarray(a),
                                               h2=jnp.asarray(b),
                                               node_mask=jnp.asarray(mask))
    got = TC.DualBranchContrast(loss=loss, tau=0.2, block_size=32)(
        _t(a), _t(b), node_mask=_t(mask))
    _close(got, ref, 1e-5, 1e-5)


def test_rejects_unported_losses():
    """`jsd` and `bootstrap` are ported now; a name the JAX package does
    not have, an unknown mode, and an identity-positive loss off L2L are
    rejected at construction."""
    TC.DualBranchContrast(loss="jsd")
    with pytest.raises(ValueError):
        TC.DualBranchContrast(loss="triplet")
    with pytest.raises(ValueError):
        TC.DualBranchContrast(loss="infonce", mode="L2G")
    with pytest.raises(ValueError):
        TC.DualBranchContrast(loss="infonce_fused", mode="G2G")
