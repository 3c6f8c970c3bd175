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


def _pair_inputs(n, f, seed):
    a, b, mask = _data(n, f, seed)
    return K.l2norm(_t(a)), K.l2norm(_t(b)), _t(mask)


def _float64_pair(a, b, mask, tau):
    """Values of both directions and the float64 gradients of
    0.5 (l(a, b) + l(b, a)), through autograd on the plain forward."""
    x = a.double().requires_grad_(True)
    y = b.double().requires_grad_(True)
    out1, _ = K.infonce_fwd_plain(x, y, tau)
    out2, _ = K.infonce_fwd_plain(y, x, tau)
    loss = 0.5 * (K.masked_mean_loss(out1, mask)
                  + K.masked_mean_loss(out2, mask))
    loss.backward()
    return loss.detach(), out1.detach(), out2.detach(), x.grad, y.grad


@pytest.mark.parametrize("mask_on", [False, True])
@pytest.mark.parametrize("n,f,tau", [(333, 8, 0.2), (100, 12, 0.5),
                                     (65, 4, 0.3)])
def test_pair_plain_matches_float64(mask_on, n, f, tau):
    """The pair's plain versions: one pass for both directions' values
    (rtol 1e-5), and the two gradient calls, one a side, against float64
    gradients of 0.5 (l(a, b) + l(b, a)) (rtol 1e-4); n ragged against
    the kernels' 64 and 32."""
    a, b, mask = _pair_inputs(n, f, seed=n + f)
    m = mask if mask_on else None
    _loss64, o1_64, o2_64, da64, db64 = _float64_pair(a, b, m, tau)
    o1, lse1, o2, lse2 = K.infonce_fwd_pair_plain(a, b, tau, block=64)
    torch.testing.assert_close(o1.double(), o1_64, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(o2.double(), o2_64, rtol=1e-5, atol=1e-5)
    w = torch.ones(n) if m is None else m.float()
    g = -0.5 * w / w.sum()  # d loss / d out, either direction
    for got, ref in ((K.infonce_bwd_pair(a, b, lse1, g, lse2, g, tau), da64),
                     (K.infonce_bwd_pair(b, a, lse2, g, lse1, g, tau), db64)):
        torch.testing.assert_close(got.double(), ref, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("mask_on", [False, True])
@pytest.mark.parametrize("f,pair", [(8, True), (10, False)])
def test_dual_branch_fused_on_cpu_equals_two_one_way_plains(mask_on, f,
                                                           pair):
    """`DualBranchContrast("infonce_fused")` on CPU tensors: the pair's
    plain versions where the shape rule takes the pair (f % 4 == 0), the
    one-way ones elsewhere; either way the value and both gradients of
    the two one-way plain directions, no kernel launched, and the counter
    `infonce.pair` at 1 or 0 while a profiler records."""
    from rlap_tpu_torch.utils import tracing

    a, b, mask = _data(150, f, seed=11 + f)
    m = _t(mask) if mask_on else None
    res = []
    for fused in (True, False):
        x, y = _t(a, True), _t(b, True)
        before = dict(K.launch_counts)
        with torch.profiler.profile():
            if fused:
                loss = TC.DualBranchContrast("infonce_fused", tau=0.2)(
                    x, y, node_mask=m)
            else:
                loss = 0.5 * (K.infonce_fused_plain(x, y, 0.2, m)
                              + K.infonce_fused_plain(y, x, 0.2, m))
            counted = tracing.counters()
        loss.backward()
        assert K.launch_counts == before
        res.append((counted, loss.detach(), x.grad, y.grad))
    assert res[0][0] == {"infonce.pair": 1.0 if pair else 0.0}
    assert K.takes_pair(K.l2norm(_t(a)), K.l2norm(_t(b))) == pair
    torch.testing.assert_close(res[0][1], res[1][1], rtol=1e-5, atol=1e-6)
    for got, want in zip(res[0][2:], res[1][2:]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-7)


def test_pair_below_the_fixed_shift_takes_two_forwards_on_cpu():
    """Under `PAIR_FWD_MIN_TAU` the pair's forward is the one-way forward
    twice; its value and gradients are the same function."""
    a, b, mask = _data(120, 8, seed=2)
    for tau in (K.PAIR_FWD_MIN_TAU * 0.8, K.PAIR_FWD_MIN_TAU * 1.25):
        loss = K.infonce_fused_pair(_t(a, True), _t(b, True), tau, _t(mask))
        ref = _float64_pair(K.l2norm(_t(a)), K.l2norm(_t(b)), _t(mask), tau)
        torch.testing.assert_close(loss.detach().double(), ref[0],
                                   rtol=1e-5, atol=1e-6)


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
