"""The arithmetic of the port's tensor-core InfoNCE kernels (forward, dA
and dB, and the pair's forward and gradient, which make both directions of
the dual-branch loss at once), emulated in plain PyTorch on the CPU: every
operand is split into
hi = tf32(x) and lo = tf32(x - hi), and a product is taken as
lo.hi + hi.lo + hi.hi in float32 ("3xTF32"); the gradients shift both
products by a row r and sum tile by tile. Held against float64, against
one TF32 pass (which is why there are three), and against the JAX package's
fused InfoNCE (its Pallas kernel in interpret mode); an emulation of the
tensor cores' truncating adds shows why the similarity is shifted. The
CUDA kernels themselves are held against their plain versions on the card,
in `test_torch_kernels.py`."""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlap_tpu.ops.infonce_pallas import infonce_fused as j_fused
from rlap_tpu_torch.ops import infonce_fused as K


@pytest.fixture(autouse=True)
def _one_thread():
    """The emulations run many small tensor operations. Under a parallel
    test run every worker's spare intra-op threads spin at each operation's
    barrier, which costs more than the threads save, so these tests use
    one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(x: float) -> int:
    return struct.unpack("<I", struct.pack("<f", x))[0]


# float32 bit pattern in, the pattern cvt.rna.tf32.f32 gives out: the low
# 13 mantissa bits go, to nearest, ties away from zero
@pytest.mark.parametrize("name,bits_in,bits_out", [
    ("representable", 0x3F802000, 0x3F802000),    # 1 + 2^-10
    ("below_half", 0x3F800FFF, 0x3F800000),       # rounds down to 1
    ("tie_goes_away", 0x3F801000, 0x3F802000),    # 1 + 2^-11 -> 1 + 2^-10
    ("above_half", 0x3F801001, 0x3F802000),
    ("negative_tie", 0xBF801000, 0xBF802000),     # away from zero
    ("carry_into_exponent", 0x3FFFF000, 0x40000000),  # just under 2 -> 2
    ("zero", 0x00000000, 0x00000000),
    ("negative_zero", 0x80000000, 0x80000000),
    ("pi", _bits(3.14159265), 0x40490000),        # 0x40490FDB, down
    ("infinity", 0x7F800000, 0x7F800000),
])
def test_tf32_round_bit_patterns(name, bits_in, bits_out):
    x = torch.from_numpy(np.array([bits_in], np.uint32).view(np.float32))
    got = K.tf32_round(x).numpy().view(np.uint32)[0]
    assert int(got) == bits_out


def test_tf32_round_keeps_10_mantissa_bits_and_half_an_ulp():
    x = torch.tensor(np.random.default_rng(0).normal(size=4096),
                     dtype=torch.float32)
    y = K.tf32_round(x)
    assert int((y.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((y - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert torch.equal(K.tf32_round(y), y)


def _unit_rows(kind: str, n: int, f: int, seed: int, spread: float = 0.03):
    r = np.random.default_rng(seed)
    c = r.normal(size=(1, f)) if kind == "alike" else 0.0
    s = spread if kind == "alike" else 1.0
    return [K.l2norm(torch.tensor(c + s * r.normal(size=(n, f)),
                                  dtype=torch.float32)) for _ in range(2)]


@pytest.mark.parametrize("kind", ["random", "alike"])
def test_three_passes_recover_float32_and_one_does_not(kind):
    """On unit rows at n=2000, f=128 the 3xTF32 product is within 2e-6 of
    the float64 product and no more than twice as far from it as the plain
    float32 product; a single TF32 pass is off by more than 1e-5."""
    p, q = _unit_rows(kind, 2000, 128, seed=1)
    ref = p.double() @ q.double().T
    err3 = float((K.matmul_3xtf32(p, q).double() - ref).abs().max())
    err32 = float(((p @ q.T).double() - ref).abs().max())
    err1 = float(((K.tf32_round(p) @ K.tf32_round(q).T).double()
                  - ref).abs().max())
    assert err3 <= 2e-6
    assert err3 <= 2 * err32
    assert err1 > 1e-5


def _alike_problem(n=2000, f=128, spread=0.03, tau=0.2):
    a, b = _unit_rows("alike", n, f, seed=2, spread=spread)
    g = torch.full((n,), -1.0 / n)
    out64, lse64 = K.infonce_fwd_plain(a.double(), b.double(), tau)
    return a, b, g, out64, lse64


def test_forward_emulation_matches_float64_on_alike_rows():
    """Values within rtol 1e-5 / atol 1e-5, the bar the kernel is held to
    on the card."""
    a, b, _g, out64, lse64 = _alike_problem()
    out, lse = K.infonce_fwd_3xtf32_plain(a, b, 0.2)
    torch.testing.assert_close(out.double(), out64, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse.double(), lse64, rtol=1e-5, atol=1e-5)


def _grad_errors(grad, spread, n=2000):
    """Errors of the kernels' arithmetic (`emulated`) and of the plain
    float32 version, relative to the largest entry of the float64 result,
    for `grad` "da" or "db" on alike rows."""
    a, b, g, _out64, lse64 = _alike_problem(n=n, spread=spread)
    plain = {"da": K.infonce_bwd_da_plain, "db": K.infonce_bwd_db_plain}[grad]
    emulate = {"da": K.infonce_bwd_da_3xtf32_plain,
               "db": K.infonce_bwd_db_3xtf32_plain}[grad]
    ref = plain(a.double(), b.double(), lse64, g.double(), 0.2)
    lse = lse64.float()

    def err(x):
        return float((x.double() - ref).abs().max() / ref.abs().max())

    return err(emulate(a, b, lse, g, 0.2)), err(plain(a, b, lse, g, 0.2))


@pytest.mark.parametrize("spread", [0.03, 0.003])
def test_da_emulation_matches_float64_on_alike_rows(spread):
    """The gradient cancels nearly equal terms on alike rows, so it is held
    within 1e-4 of the largest entry of the float64 result. Summing
    coef_ij (B_j - r) keeps it there however alike the rows are, where the
    plain float32 sum of coef_ij B_j loses a digit for each digit of
    likeness."""
    emulated, plain = _grad_errors("da", spread)
    assert emulated <= 1e-4
    assert emulated <= plain


@pytest.mark.parametrize("spread,bar", [(0.03, 1e-4), (0.003, 2e-4)])
def test_db_emulation_matches_float64_on_alike_rows(spread, bar):
    """dB on alike rows: within 1e-4 of the largest entry of the float64
    result at spread 0.03, and 2e-4 at spread 0.003, where the rounding of
    the float32 coefficients weighs more (dB's column sums c_j do not
    vanish, so it reaches the result through r c_j); and no worse than the
    plain float32 version."""
    emulated, plain = _grad_errors("db", spread)
    assert emulated <= bar
    assert emulated <= plain


def _pair_problem(kind, n, spread, mask_on, tau=0.2):
    """Unit rows, the per-row gradients of 0.5 (l(a, b) + l(b, a)) under
    an anchor mask, and the float64 references: lse1, lse2 and dA, dB of
    the pair."""
    a, b = _unit_rows(kind, n, 128 if kind == "alike" else 50, seed=n,
                      spread=spread)
    r = np.random.default_rng(n + 1)
    w = (torch.tensor(r.random(n) < 0.85, dtype=torch.float32) if mask_on
         else torch.ones(n))
    g = -0.5 * w / w.sum()
    a64, b64, g64 = a.double(), b.double(), g.double()
    _o1, lse1, _o2, lse2 = K.infonce_fwd_pair_plain(a64, b64, tau)
    da = K.infonce_bwd_pair_plain(a64, b64, lse1, g64, lse2, g64, tau)
    db = K.infonce_bwd_pair_plain(b64, a64, lse2, g64, lse1, g64, tau)
    return a, b, g, lse1, lse2, {"a": da, "b": db}


# n ragged against the gradients' 64 and 32, with and without a mask, and
# alike rows
@pytest.mark.parametrize("side", ["a", "b"])
@pytest.mark.parametrize("kind,n,spread,mask_on", [
    ("random", 333, 1.0, False), ("random", 333, 1.0, True),
    ("alike", 1000, 0.03, True), ("alike", 2000, 0.003, False)])
def test_pair_emulation_matches_float64(side, kind, n, spread, mask_on):
    """The pair gradient kernel's arithmetic (`_bwd_3xtf32_plain` with both
    anchors' terms, the add-back of the streamed ones' sums), on either
    owner side, within 1e-4 of the largest entry of the float64 gradient
    of 0.5 (l(a, b) + l(b, a)), as tight as the one-way dA; and no worse
    than the plain float32 version."""
    a, b, g, lse1, lse2, refs = _pair_problem(kind, n, spread, mask_on)
    l1, l2 = lse1.float(), lse2.float()
    p, q, own, streamed = ((a, b, l1, l2) if side == "a" else (b, a, l2, l1))
    ref = refs[side]

    def err(x):
        return float((x.double() - ref).abs().max() / ref.abs().max())

    emulated = err(K.infonce_bwd_pair_3xtf32_plain(p, q, own, g, streamed, g,
                                                   0.2))
    plain = err(K.infonce_bwd_pair_plain(p, q, own, g, streamed, g, 0.2))
    assert emulated <= 1e-4
    assert emulated <= max(plain, 1e-6)


@pytest.mark.parametrize("kind,spread", [("random", 1.0), ("alike", 0.03),
                                         ("alike", 0.003)])
@pytest.mark.parametrize("tau", [0.2, K.PAIR_FWD_MIN_TAU])
def test_pair_forward_emulation_matches_float64(kind, spread, tau):
    """The pair forward kernel's arithmetic: the fixed shift by 1/tau in
    place of a running max keeps both directions' values and logsumexps
    within rtol 1e-5 of float64, down to `PAIR_FWD_MIN_TAU`, on n ragged
    against its 128 rows."""
    a, b = _unit_rows(kind, 1000, 128, seed=5, spread=spread)
    refs = K.infonce_fwd_pair_plain(a.double(), b.double(), tau)
    for got, ref in zip(K.infonce_fwd_pair_3xtf32_plain(a, b, tau), refs):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-5)


def _truncating_3xtf32(p, q):
    """p @ q.T in 3xTF32 as `wgmma` takes it: hi = x cut to TF32, lo =
    x - hi rounded to TF32; per 8 features the three terms lo.hi, hi.lo,
    hi.hi are each added to the float32 accumulator exactly and the sum
    cut toward zero to float32, as the tensor cores add."""
    ph, qh = K.tf32_truncate(p), K.tf32_truncate(q)
    pl, ql = K.tf32_round(p - ph), K.tf32_round(q - qh)
    acc = torch.zeros(p.shape[0], q.shape[0])
    for k0 in range(0, p.shape[1], 8):
        for x, y in ((pl, qh), (ph, ql), (ph, qh)):
            exact = acc.double() + (x[:, k0:k0 + 8].double()
                                    @ y[:, k0:k0 + 8].double().T)
            acc = exact.float()
            acc = torch.where(acc.double().abs() > exact.abs(),
                              torch.nextafter(acc, torch.zeros_like(acc)), acc)
    return acc


def test_shifted_similarity_keeps_db_clear_of_truncation():
    """Why the gradient kernels take a tile's similarity against Q - r
    and add P_row . r back: with truncating adds, A_i . B_j near 1 comes
    out low by about the same amount for every pair, every coefficient
    moves alike, and dB (whose column sums do not vanish) misses its
    2e-4 bar on rows alike to 0.003. Against A - r the similarity is small
    and so is what truncation takes: within 1e-4. dB is taken in float64
    from float32 coefficients, so only the similarity differs."""
    n, tau = 400, 0.2
    a, b, g, _out64, lse64 = _alike_problem(n=n, spread=0.003)
    ref = K.infonce_bwd_db_plain(a.double(), b.double(), lse64, g.double(),
                                 tau)
    lse = lse64.float()

    def err(s):  # s[j, i] = B_j . A_i in float32
        coef = -torch.exp(s.T * (1.0 / tau) - lse[:, None])
        coef.diagonal().add_(1.0)
        coef = coef * (g[:, None] * (1.0 / tau))
        db = coef.double().T @ a.double()
        return float((db - ref).abs().max() / ref.abs().max())

    shifted = torch.empty(n, n)
    for j0 in range(0, n, 64):
        r = a[j0]
        t = b[j0:j0 + 64].double() @ r.double()
        t_hi = t.float()
        t_lo = (t - t_hi.double()).float()
        shifted[j0:j0 + 64] = ((_truncating_3xtf32(b[j0:j0 + 64], a - r)
                                + t_lo[:, None]) + t_hi[:, None])
    assert err(_truncating_3xtf32(b, a)) > 2e-4
    assert err(shifted) <= 1e-4


def _check_random_rows(emulate, plain):
    """Within rtol 1e-4 / atol 1e-6 of the plain version, the bar the
    kernels are held to on the card; ragged n and f."""
    a, b = _unit_rows("random", 333, 50, seed=3)
    g = torch.tensor(np.random.default_rng(4).normal(size=333),
                     dtype=torch.float32) / 333
    _out, lse = K.infonce_fwd_plain(a, b, 0.5)
    torch.testing.assert_close(emulate(a, b, lse, g, 0.5),
                               plain(a, b, lse, g, 0.5), rtol=1e-4, atol=1e-6)


def test_da_emulation_matches_plain_on_random_rows():
    _check_random_rows(K.infonce_bwd_da_3xtf32_plain, K.infonce_bwd_da_plain)


def test_db_emulation_matches_plain_on_random_rows():
    _check_random_rows(K.infonce_bwd_db_3xtf32_plain, K.infonce_bwd_db_plain)


@pytest.mark.parametrize("mask_on", [False, True])
@pytest.mark.parametrize("n,f,tau", [(160, 16, 0.5), (133, 10, 0.2)])
def test_emulated_value_and_grads_match_jax(mask_on, n, f, tau):
    """Value (rtol 1e-5) and both gradients (rtol 1e-4) of the loss, with
    the forward, dA and dB in the kernels' arithmetic, against the JAX
    package's fused InfoNCE."""
    r = np.random.default_rng(3 + n)
    x = r.normal(size=(n, f)).astype(np.float32)
    y = r.normal(size=(n, f)).astype(np.float32)
    mask = r.random(n) < 0.85
    jm = jnp.asarray(mask) if mask_on else None

    def jloss(u, v):
        return j_fused(u, v, tau=tau, anchor_mask=jm, block_m=128,
                       block_n=128)

    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                      jnp.asarray(y))
    tx, ty = torch.tensor(x, requires_grad=True), torch.tensor(
        y, requires_grad=True)
    a, b = K.l2norm(tx), K.l2norm(ty)
    ad, bd = a.detach(), b.detach()
    out, lse = K.infonce_fwd_3xtf32_plain(ad, bd, tau)
    m = torch.tensor(mask if mask_on else np.ones(n, bool))
    loss = K.masked_mean_loss(out, m)
    g = -m.float() / m.float().sum()  # d loss / d out
    torch.autograd.backward(
        [a, b], [K.infonce_bwd_da_3xtf32_plain(ad, bd, lse, g, tau),
                 K.infonce_bwd_db_3xtf32_plain(ad, bd, lse, g, tau)])
    np.testing.assert_allclose(loss.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jg[1]), rtol=1e-4,
                               atol=1e-7)
