"""The arithmetic of the port's tensor-core InfoNCE kernels (forward and
dA), emulated in plain PyTorch on the CPU: every operand is split into
hi = tf32(x) and lo = tf32(x - hi), and a product is taken as
lo.hi + hi.lo + hi.hi in float32 ("3xTF32"). Held against float64, against
one TF32 pass (which is why there are three), and against the JAX package's
fused InfoNCE (its Pallas kernel in interpret mode). The CUDA kernels
themselves are held against their plain versions on the card, in
`test_torch_kernels.py`."""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlap_tpu.ops.infonce_pallas import infonce_fused as j_fused
from rlap_tpu_torch.ops import infonce_fused as K


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


@pytest.mark.parametrize("spread", [0.03, 0.003])
def test_da_emulation_matches_float64_on_alike_rows(spread):
    """The gradient cancels nearly equal terms on alike rows, so it is held
    within 1e-4 of the largest entry of the float64 result. Summing
    coef_ij (B_j - r) keeps it there however alike the rows are, where the
    plain float32 sum of coef_ij B_j loses a digit for each digit of
    likeness."""
    a, b, g, _out64, lse64 = _alike_problem(spread=spread)
    ref = K.infonce_bwd_da_plain(a.double(), b.double(), lse64, g.double(),
                                 0.2)
    lse = lse64.float()

    def err(x):
        return float((x.double() - ref).abs().max() / ref.abs().max())

    emulated = err(K.infonce_bwd_da_3xtf32_plain(a, b, lse, g, 0.2))
    assert emulated <= 1e-4
    assert emulated <= err(K.infonce_bwd_da_plain(a, b, lse, g, 0.2))


def test_da_emulation_matches_plain_on_random_rows():
    """Gradients within rtol 1e-4 / atol 1e-6 of the plain version, the bar
    the kernel is held to on the card; ragged n and f."""
    a, b = _unit_rows("random", 333, 50, seed=3)
    g = torch.tensor(np.random.default_rng(4).normal(size=333),
                     dtype=torch.float32) / 333
    _out, lse = K.infonce_fwd_plain(a, b, 0.5)
    torch.testing.assert_close(
        K.infonce_bwd_da_3xtf32_plain(a, b, lse, g, 0.5),
        K.infonce_bwd_da_plain(a, b, lse, g, 0.5), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mask_on", [False, True])
@pytest.mark.parametrize("n,f,tau", [(160, 16, 0.5), (133, 10, 0.2)])
def test_emulated_value_and_grads_match_jax(mask_on, n, f, tau):
    """Value (rtol 1e-5) and both gradients (rtol 1e-4) of the loss, with
    the forward and dA in the kernels' arithmetic and dB plain, as on the
    card, against the JAX package's fused InfoNCE."""
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
                 K.infonce_bwd_db_plain(ad, bd, lse, g, tau)])
    np.testing.assert_allclose(loss.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(jg[1]), rtol=1e-4,
                               atol=1e-7)
