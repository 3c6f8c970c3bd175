"""The CUDA kernels (fused InfoNCE, access probes) against their plain
PyTorch versions, and the wrappers' device rules. This file imports nothing of JAX, so on a
machine with a card and no JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The `cuda` tests skip without a card (the kernels have no CPU mode).
InfoNCE values within rtol 1e-5 / atol 1e-5, gradients within rtol 1e-4 /
atol 1e-6, in float32 with TF32 off; on alike rows all three kernels are
held against float64, within 1e-4 of the largest entry (dB 2e-4 on rows
alike to 0.003, where the rounding of its float32 coefficients reaches it
through its column sums). The pair kernels (both directions of the
dual-branch loss at once) are held to the same values and gradients,
against their plain versions, the one-way kernels and float64 (within 1e-4
on alike rows at both spreads), bit-equal from run to run, and to the shape
rule and launch counts of their callers. The access probes are int32 and
must be bit-equal: the eight kernels at the probes' shapes, C1 and V1 on
ragged and offset indices and unaligned tables, C1 and the scatter-min on
hub-heavy streams (`tests/test_torch_access_cases.py`), the cluster walk of
C3 at each cluster size of its plan, with its cycle counts, the
cluster-resident table of C2 at each swept cluster size, at the plan's
capacity edge, on ragged and offset indices, with its spans, V4 on a table
past that edge, and the column slabs of V2 at each slab width, on ragged,
offset and hub-heavy indices, at the plan's edges. The roofline's price
measurement holds C1 and C4 bit-equal before it times them.
"""

import numpy as np
import pytest
import torch
import test_torch_access_cases as cases

from rlap_tpu_torch.bench import probe_access as P
from rlap_tpu_torch.bench import roofline as RL
from rlap_tpu_torch.ops import access as A
from rlap_tpu_torch.ops import infonce_fused as K


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(n, f, seed, device):
    r = np.random.default_rng(seed)
    a = K.l2norm(torch.tensor(r.normal(size=(n, f)), dtype=torch.float32))
    b = K.l2norm(torch.tensor(r.normal(size=(n, f)), dtype=torch.float32))
    m = torch.tensor(r.random(n) < 0.85, dtype=torch.float32)
    g = -m / m.sum()
    return [t.to(device).contiguous() for t in (a, b, m, g)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,tau", [(1000, 100, 0.2), (2048, 128, 0.5),
                                     (70, 300, 0.2), (129, 100, 0.2),
                                     (4097, 72, 0.2), (500, 50, 0.5),
                                     (333, 1000, 0.2), (7, 4, 0.5),
                                     (33, 8, 0.2), (65, 124, 0.5),
                                     (3000, 256, 0.2), (1000, 128, 0.2)])
def test_cuda_kernels_match_plain(n, f, tau):
    _needs_card()
    a, b, _m, g = _inputs(n, f, n + f, "cuda")
    before = dict(K.launch_counts)
    out, lse = K.infonce_fwd(a, b, tau)
    out_p, lse_p = K.infonce_fwd_plain(a, b, tau)
    torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(K.infonce_bwd_da(a, b, lse_p, g, tau),
                               K.infonce_bwd_da_plain(a, b, lse_p, g, tau),
                               rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(K.infonce_bwd_db(a, b, lse_p, g, tau),
                               K.infonce_bwd_db_plain(a, b, lse_p, g, tau),
                               rtol=1e-4, atol=1e-6)
    torch.cuda.synchronize()
    assert all(K.launch_counts[k] == before[k] + 1 for k in K.KERNELS)


@pytest.mark.cuda
def test_cuda_kernels_take_rows_that_are_not_16_byte_aligned():
    """A contiguous view one float into its storage: the 16-byte copies of
    the tensor-core kernels do not apply, and the 4-byte path must give the
    same values."""
    _needs_card()
    n, f, tau = 300, 64, 0.2
    a, b, _m, g = _inputs(n, f, 7, "cuda")

    def shifted(x):
        store = torch.empty(x.numel() + 1, device="cuda")
        view = store[1:].view(x.shape)
        view.copy_(x)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view

    out, lse = K.infonce_fwd(a, b, tau)
    out_s, lse_s = K.infonce_fwd(shifted(a), shifted(b), tau)
    torch.testing.assert_close(out_s, out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse_s, lse, rtol=1e-5, atol=1e-5)
    for grad in (K.infonce_bwd_da, K.infonce_bwd_db):
        torch.testing.assert_close(grad(shifted(a), shifted(b), lse, g, tau),
                                   grad(a, b, lse, g, tau), rtol=1e-4,
                                   atol=1e-6)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [0.03, 0.003])
def test_cuda_kernels_match_float64_on_alike_rows(spread):
    """Rows that share a direction, as a fresh encoder's embeddings do: the
    gradients cancel nearly equal terms, so all three kernels are held
    against float64, within 1e-4 of the largest entry; dB within 2e-4 at
    spread 0.003, where the rounding of its float32 coefficients weighs
    more (its column sums do not vanish, so it reaches the result)."""
    _needs_card()
    n, f, tau = 5000, 128, 0.2
    r = np.random.default_rng(11)
    c = r.normal(size=(1, f))
    a, b = (K.l2norm(torch.tensor(c + spread * r.normal(size=(n, f)),
                                  dtype=torch.float32)).cuda().contiguous()
            for _ in range(2))
    g = torch.full((n,), -1.0 / n, device="cuda")
    a64, b64, g64 = a.double(), b.double(), g.double()
    out64, lse64 = K.infonce_fwd_plain(a64, b64, tau)
    da64 = K.infonce_bwd_da_plain(a64, b64, lse64, g64, tau)
    db64 = K.infonce_bwd_db_plain(a64, b64, lse64, g64, tau)
    lse = lse64.float().contiguous()
    out, _lse = K.infonce_fwd(a, b, tau)
    da = K.infonce_bwd_da(a, b, lse, g, tau)
    db = K.infonce_bwd_db(a, b, lse, g, tau)
    torch.cuda.synchronize()
    db_bar = 1e-4 if spread == 0.03 else 2e-4
    for got, ref, bar in ((out, out64, 1e-4), (da, da64, 1e-4),
                          (db, db64, db_bar)):
        err = (got.double() - ref).abs().max() / ref.abs().max()
        assert float(err) <= bar


@pytest.mark.cuda
def test_cuda_rejects_rows_too_wide_for_shared_memory():
    """The kernels keep a block's rows resident in shared memory: f > 1920
    does not fit, and the launch is refused, not run some other way."""
    _needs_card()
    a, b, _m, g = _inputs(40, 2000, 1, "cuda")
    with pytest.raises(RuntimeError):
        K.infonce_fwd(a, b, 0.2)
    for grad in (K.infonce_bwd_da, K.infonce_bwd_db):
        with pytest.raises(RuntimeError):
            grad(a, b, g, g, 0.2)


@pytest.mark.cuda
def test_cuda_autograd_matches_plain():
    _needs_card()
    a, b, m, _g = _inputs(777, 64, 3, "cuda")
    res = []
    for fn in (K.infonce_fused, K.infonce_fused_plain):
        x, y = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        loss = fn(x, y, tau=0.2, anchor_mask=m.bool())
        loss.backward()
        res.append((loss.detach(), x.grad, y.grad))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=1e-5, atol=1e-5)
    for got, want in zip(res[0][1:], res[1][1:]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def _launched(before):
    return {k: K.launch_counts[k] - before[k] for k in K.launch_counts}


def _pair_launches(fwd_pair, bwd_pair, fwd=0, da=0, db=0):
    return {"infonce_fwd": fwd, "infonce_bwd_da": da, "infonce_bwd_db": db,
            "infonce_fwd_pair": fwd_pair, "infonce_bwd_pair": bwd_pair}


def _pair_grads(a, b, lse1, g1, lse2, g2, tau, fn):
    """dA and dB of the pair from `fn` (the pair kernel or its plain
    version) on both sides."""
    return (fn(a, b, lse1, g1, lse2, g2, tau),
            fn(b, a, lse2, g2, lse1, g1, tau))


# the shapes of the pair: f <= 128, f % 4 == 0; ragged n against the
# forward's 128 rows and 64 columns and the gradients' 64 and 32
@pytest.mark.cuda
@pytest.mark.parametrize("n,f,tau", [(1000, 100, 0.2), (2048, 128, 0.5),
                                     (129, 100, 0.2), (4097, 72, 0.2),
                                     (7, 4, 0.5), (33, 8, 0.2),
                                     (65, 124, 0.5), (1000, 128, 0.2),
                                     (20001, 32, 0.2)])
def test_cuda_pair_kernels_match_plain_and_the_one_way_kernels(n, f, tau):
    """The pair forward against its plain version and the two one-way
    forwards (rtol 1e-5 / atol 1e-5); the pair gradients against their
    plain versions and against the sum of the four one-way launches that
    make the same gradients (rtol 1e-4 / atol 1e-6)."""
    _needs_card()
    a, b, _m, g1 = _inputs(n, f, n + f, "cuda")
    g2 = torch.roll(g1, 1) * 0.5
    before = dict(K.launch_counts)
    got = K.infonce_fwd_pair(a, b, tau)
    plain = K.infonce_fwd_pair_plain(a, b, tau)
    one_way = K.infonce_fwd(a, b, tau) + K.infonce_fwd(b, a, tau)
    for x, p, w in zip(got, plain, one_way):
        torch.testing.assert_close(x, p, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(x, w, rtol=1e-5, atol=1e-5)
    _o1, lse1, _o2, lse2 = plain
    da, db = _pair_grads(a, b, lse1, g1, lse2, g2, tau, K.infonce_bwd_pair)
    da_p, db_p = _pair_grads(a, b, lse1, g1, lse2, g2, tau,
                             K.infonce_bwd_pair_plain)
    da4 = (K.infonce_bwd_da(a, b, lse1, g1, tau)
           + K.infonce_bwd_db(b, a, lse2, g2, tau))
    db4 = (K.infonce_bwd_db(a, b, lse1, g1, tau)
           + K.infonce_bwd_da(b, a, lse2, g2, tau))
    for x, p, w in ((da, da_p, da4), (db, db_p, db4)):
        torch.testing.assert_close(x, p, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(x, w, rtol=1e-4, atol=1e-6)
    torch.cuda.synchronize()
    assert _launched(before) == _pair_launches(1, 2, fwd=2, da=2, db=2)


@pytest.mark.cuda
def test_cuda_pair_kernels_repeat_bit_for_bit():
    """No atomics: two runs of the pair give the same bits."""
    _needs_card()
    n, f, tau = 5003, 128, 0.2
    a, b, _m, g1 = _inputs(n, f, 5, "cuda")
    g2 = torch.roll(g1, 3)
    runs = []
    for _ in range(2):
        out = K.infonce_fwd_pair(a, b, tau)
        _o1, lse1, _o2, lse2 = out
        runs.append(out + _pair_grads(a, b, lse1, g1, lse2, g2, tau,
                                      K.infonce_bwd_pair))
    torch.cuda.synchronize()
    for x, y in zip(*runs):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [0.03, 0.003])
def test_cuda_pair_kernels_match_float64_on_alike_rows(spread):
    """Rows that share a direction: both directions' values and the pair's
    gradients within 1e-4 of the largest entry of the float64 result. The
    add-back sums only the streamed rows' terms, so neither side carries
    the rounding of the owned rows' sums."""
    _needs_card()
    n, f, tau = 5000, 128, 0.2
    r = np.random.default_rng(12)
    c = r.normal(size=(1, f))
    a, b = (K.l2norm(torch.tensor(c + spread * r.normal(size=(n, f)),
                                  dtype=torch.float32)).cuda().contiguous()
            for _ in range(2))
    g = torch.full((n,), -0.5 / n, device="cuda")
    a64, b64, g64 = a.double(), b.double(), g.double()
    o1_64, lse1_64, o2_64, lse2_64 = K.infonce_fwd_pair_plain(a64, b64, tau)
    refs = (o1_64, o2_64) + _pair_grads(a64, b64, lse1_64, g64, lse2_64,
                                        g64, tau, K.infonce_bwd_pair_plain)
    o1, _lse1, o2, _lse2 = K.infonce_fwd_pair(a, b, tau)
    got = (o1, o2) + _pair_grads(a, b, lse1_64.float(), g, lse2_64.float(),
                                 g, tau, K.infonce_bwd_pair)
    torch.cuda.synchronize()
    for x, ref in zip(got, refs):
        err = (x.double() - ref).abs().max() / ref.abs().max()
        assert float(err) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("f,pair", [(128, True), (32, True), (130, False),
                                    (126, False)])
def test_cuda_pair_takes_the_wgmma_widths(f, pair):
    """The shape rule: the pair at f <= 128 with f % 4 == 0, else the
    one-way kernels (two forwards, two dA, two dB); the pair's wrappers
    refuse the other widths rather than run them some other way."""
    _needs_card()
    n = 300
    a, b, _m, g = _inputs(n, f, f, "cuda")
    assert K.takes_pair(a, b) == pair
    x, y = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    before = dict(K.launch_counts)
    out1, out2 = K.infonce_pair(x, y, 0.2)
    ((out1 + out2) * g).sum().backward()
    torch.cuda.synchronize()
    assert _launched(before) == (_pair_launches(1, 2) if pair else
                                 _pair_launches(0, 0, fwd=2, da=2, db=2))
    if not pair:
        with pytest.raises(RuntimeError):
            K.infonce_fwd_pair(a, b, 0.2)
        with pytest.raises(RuntimeError):
            K.infonce_bwd_pair(a, b, g, g, g, g, 0.2)


@pytest.mark.cuda
def test_cuda_pair_refuses_rows_that_are_not_16_byte_aligned():
    """Rows one float into their storage take the one-way kernels, whose
    4-byte path gives the pair's values."""
    _needs_card()
    n, f, tau = 300, 64, 0.2
    a, b, _m, g = _inputs(n, f, 9, "cuda")

    def shifted(x):
        store = torch.empty(x.numel() + 1, device="cuda")
        view = store[1:].view(x.shape)
        view.copy_(x)
        return view.requires_grad_(True)

    res = []
    for x, y in ((a.clone().requires_grad_(True),
                  b.clone().requires_grad_(True)), (shifted(a), shifted(b))):
        before = dict(K.launch_counts)
        out1, out2 = K.infonce_pair(x, y, tau)
        ((out1 + out2) * g).sum().backward()
        torch.cuda.synchronize()
        res.append((_launched(before), out1, out2, x.grad, y.grad))
    assert res[0][0] == _pair_launches(1, 2)
    assert res[1][0] == _pair_launches(0, 0, fwd=2, da=2, db=2)
    for got, want in zip(res[1][1:3], res[0][1:3]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for got, want in zip(res[1][3:], res[0][3:]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_cuda_pair_below_the_fixed_shift_takes_two_forwards():
    """At tau under `PAIR_FWD_MIN_TAU` the pair's forward is two one-way
    launches, its gradients the pair kernels; the values and gradients
    still match the plain loss."""
    _needs_card()
    n, f, tau = 500, 64, 0.02
    a, b, m, _g = _inputs(n, f, 4, "cuda")
    res = []
    for fn in (K.infonce_fused_pair, _two_plain_directions):
        x, y = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        before = dict(K.launch_counts)
        loss = fn(x, y, tau=tau, anchor_mask=m.bool())
        loss.backward()
        torch.cuda.synchronize()
        res.append((_launched(before), loss.detach(), x.grad, y.grad))
    assert res[0][0] == _pair_launches(0, 2, fwd=2)
    torch.testing.assert_close(res[0][1], res[1][1], rtol=1e-5, atol=1e-5)
    for got, want in zip(res[0][2:], res[1][2:]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def _two_plain_directions(h1, h2, tau, anchor_mask):
    return 0.5 * (K.infonce_fused_plain(h1, h2, tau, anchor_mask)
                  + K.infonce_fused_plain(h2, h1, tau, anchor_mask))


@pytest.mark.cuda
def test_cuda_grace_loss_launches_the_pair_once():
    """GRACE's loss (`DualBranchContrast`, "auto") at f = 128 on the card:
    one pair forward and two pair gradient launches, no one-way launch,
    the counter `infonce.pair` at 1 while a profiler records; the loss and
    both gradients as the plain two directions give them."""
    _needs_card()
    from rlap_tpu_torch.objectives.contrast import DualBranchContrast
    from rlap_tpu_torch.utils import tracing

    a, b, m, _g = _inputs(3001, 128, 6, "cuda")
    res = []
    for fn in (DualBranchContrast("auto", tau=0.2),
               DualBranchContrast("infonce_batched", tau=0.2)):
        x, y = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        before = dict(K.launch_counts)
        with torch.profiler.profile():
            loss = fn(x, y, node_mask=m.bool())
            counted = tracing.counters()
        loss.backward()
        torch.cuda.synchronize()
        res.append((_launched(before), counted, loss.detach(), x.grad,
                    y.grad))
    assert res[0][0] == _pair_launches(1, 2)
    assert res[0][1] == {"infonce.pair": 1.0}
    assert res[1][0] == _pair_launches(0, 0) and res[1][1] == {}
    torch.testing.assert_close(res[0][2], res[1][2], rtol=1e-5, atol=1e-5)
    for got, want in zip(res[0][3:], res[1][3:]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    a, b, _m, g = _inputs(50, 8, 0, "cpu")
    before = dict(K.launch_counts)
    out, lse = K.infonce_fwd(a, b, 0.2)
    torch.testing.assert_close(out, K.infonce_fwd_plain(a, b, 0.2)[0])
    K.infonce_bwd_da(a, b, lse, g, 0.2)
    K.infonce_bwd_db(a, b, lse, g, 0.2)
    assert K.launch_counts == before


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version: it
    launches the kernel or the wrapper raises."""
    a, b, _m, g = _inputs(50, 8, 0, "cpu")
    with pytest.raises(ValueError):
        K.infonce_fwd(a.to("meta"), b.to("meta"), 0.2)
    with pytest.raises(ValueError):
        K.infonce_bwd_da(a, b, g.to("meta"), g, 0.2)
    with pytest.raises(ValueError):
        K.infonce_fwd(a, b[:10], 0.2)


def test_timing_tool_needs_a_card(capsys):
    """`time_infonce` times kernels, so without a card it says so and
    returns 1; it never times the plain versions instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from rlap_tpu_torch.bench import time_infonce
    assert time_infonce.main(["100"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_library_is_named_by_source_hash():
    path = K.library_path()
    assert path.parent == K.BUILD_DIR
    assert path.name.startswith("libinfonce_") and path.suffix == ".so"
    assert path == K.library_path()


def test_each_source_has_its_own_library():
    """One library per `.cu` file, each named by its own source's hash."""
    import hashlib

    from rlap_tpu_torch.ops import _build
    paths = {}
    for mod, stem in ((K, "infonce"), (A, "access")):
        path = mod.library_path()
        digest = hashlib.sha256(mod.SOURCE.read_bytes() + " ".join(
            _build.NVCC_FLAGS).encode()).hexdigest()[:16]
        assert mod.SOURCE.name == f"{stem}.cu" and mod.SOURCE.exists()
        assert path == _build.BUILD_DIR / f"lib{stem}_{digest}.so"
        paths[stem] = path
    assert paths["infonce"].name.split("_")[1] != \
        paths["access"].name.split("_")[1]


# n, E, M: the probes' own tile sizes, and a ragged shape (n not a multiple
# of 128, E not of 8192 or of 4, M not of 64)
ACCESS_SHAPES = [(4096, 16384, 128), (1000, 12345, 97)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", A.KERNELS)
@pytest.mark.parametrize("n,e,m", ACCESS_SHAPES)
def test_cuda_access_kernel_matches_plain(name, n, e, m):
    _needs_card()
    inp = P.make_inputs(n, e, m, 1, "cuda", seed=n + e)
    kern, plain, args = P._calls(inp)[name]
    before = A.launch_counts[name]
    got, ref = kern(*args[0]), plain(*args[0])
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    assert A.launch_counts[name] == before + 1


@pytest.mark.cuda
def test_cuda_two_level_take_covers_several_chunks():
    """C2 on a table of 150,001 entries, more than the default cluster of
    2 blocks holds: the plan takes 3."""
    _needs_card()
    inp = P.make_inputs(150_001, 50_000, 1, 1, "cuda", seed=5)
    idx = inp["idx"][0]
    assert A.table_plan(inp["nt"]).blocks == 3
    got = A.take_two_level(inp["tab2d"], idx)
    assert torch.equal(got, A.take_two_level_plain(inp["tab2d"], idx))
    torch.cuda.synchronize()


def _cluster_case(n, e, m, seed):
    inp = P.make_inputs(n, e, m, 1, "cuda", seed=seed)
    return inp["tab2d"], inp["idx"][0], inp["idx2"][0]


def _cluster_run(n, e, seed, blocks):
    """C2 at a cluster of `blocks` (None: the plan's) on a fresh case,
    bit-equal to its plain version in one launch; its spans."""
    tab2d, idx, _idx2 = _cluster_case(n, e, 1, seed)
    cyc = torch.zeros(3, dtype=torch.int64, device="cuda")
    before = A.launch_counts["take_two_level"]
    got = A.take_two_level(tab2d, idx, blocks=blocks, cycles=cyc)
    torch.cuda.synchronize()
    assert torch.equal(got, A.take_two_level_plain(tab2d, idx))
    assert A.launch_counts["take_two_level"] == before + 1
    return cyc.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [None, 1, 2, 4, 8])
def test_cuda_cluster_table_matches_plain(blocks):
    """C2 at n=100000 at every cluster size that holds the table (and the
    default plan), bit-equal, with positive staging and lookup spans and a
    whole grid of clusters."""
    _needs_card()
    if blocks is not None and not A.table_fits(100_096, blocks):
        tab2d, idx, _idx2 = _cluster_case(100_000, 4096, 1, 3)
        with pytest.raises(ValueError):
            A.take_two_level(tab2d, idx, blocks=blocks)
        return
    stage, lookup, clusters = _cluster_run(100_000, 1_600_000, 3, blocks)
    assert stage > 0 and lookup > 0 and clusters >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 2, 8])
def test_cuda_cluster_table_small_table(blocks):
    """A table of 1000 entries (8 rows) at a cluster of 1 block, of 2,
    and of 8, where some blocks hold no entry."""
    _needs_card()
    stage, lookup, clusters = _cluster_run(1000, 12_345, 7, blocks)
    assert stage > 0 and lookup > 0 and clusters >= 1


@pytest.mark.cuda
def test_cuda_cluster_table_at_its_capacity_edge():
    """The largest table a cluster of 8 holds, bit-equal; one row more is
    refused on the card, not run some other way. V4, which reads its
    table from L2, takes that table."""
    _needs_card()
    edge = 464_768
    assert A.table_plan(edge).blocks == 8
    _cluster_run(edge, 40_000, 4, None)
    _tab2d, idx, idx2 = _cluster_case(1000, 4096, 32, 4)
    gen = torch.Generator(device="cuda").manual_seed(4)
    bigger = torch.randint(0, 1 << 30, (edge // 128 + 1, 128), generator=gen,
                           device="cuda", dtype=torch.int32)
    with pytest.raises(ValueError, match="does not fit a cluster"):
        A.take_two_level(bigger, idx)
    got = A.take_axis0_axis1(bigger, idx2)
    torch.cuda.synchronize()
    assert torch.equal(got, A.take_axis0_axis1_plain(bigger, idx2))


@pytest.mark.cuda
@pytest.mark.parametrize("skip,e", [(0, 4097), (1, 4097), (1, 50_000),
                                    (2, 3), (3, 1), (1, 0)])
def test_cuda_two_level_take_ragged_and_offset_indices(skip, e):
    """E not a multiple of 4, and index views 1-3 elements into their
    storage: a head before the first 16-byte boundary and a tail."""
    _needs_card()
    tab2d, idx, _idx2 = _cluster_case(100_000, e + skip, 1, 6)
    view = idx[skip:]
    assert view.numel() == e
    got = A.take_two_level(tab2d, view)
    torch.cuda.synchronize()
    assert got.shape == view.shape
    assert torch.equal(got, A.take_two_level_plain(tab2d, view))


def _take_run(n, idx, seed=0):
    """C1's `take` on a fresh n-entry table by `idx`: bit-equal to the
    plain version, one launch."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = torch.randint(0, 1 << 30, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
    before = A.launch_counts["take"]
    got = A.take(table, idx)
    torch.cuda.synchronize()
    assert got.shape == idx.shape and torch.equal(got,
                                                  A.take_plain(table, idx))
    assert A.launch_counts["take"] == before + 1


def _indices(n, e, seed, skip=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    idx = torch.randint(0, n, (e + skip,), generator=gen, device="cuda",
                        dtype=torch.int32)
    return idx[skip:]


@pytest.mark.cuda
@pytest.mark.parametrize("skip,e", [(0, 4097), (1, 4097), (2, 50_001),
                                    (3, 3), (1, 1), (1, 0), (0, 1_600_003)])
def test_cuda_take_ragged_and_offset_indices(skip, e):
    """E not a multiple of 4 or of a block, a few indices, none, and index
    views 1-3 elements into their storage."""
    _needs_card()
    _take_run(100_000, _indices(100_000, e, 6, skip))


@pytest.mark.cuda
def test_cuda_take_on_an_unaligned_table():
    """A table view one entry into its storage."""
    _needs_card()
    store = torch.arange(100_001, dtype=torch.int32, device="cuda") * 3
    table, idx = store[1:], _indices(100_000, 70_000, 9)
    assert table.data_ptr() % 16
    got = A.take(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, A.take_plain(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("stream", list(cases.STREAMS))
def test_cuda_take_hub_streams_match_plain(stream):
    """Runs of one index up to 3000 long, one index alone, E < 32 and a
    view one element into its storage."""
    _needs_card()
    idx, _val = cases.hub_stream(stream, "cuda")
    _take_run(cases.SIZE, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [332_257, 4_000_000])
def test_cuda_take_takes_any_table(n):
    """Tables past what a cluster's shared memory would hold: C1 reads
    from L2 and has no plan to refuse them."""
    _needs_card()
    _take_run(n, _indices(n, 300_001, 10))


# V1: (nt, M, elements the tile view lies into its storage): the probes'
# shape, a ragged M, a view one 16-byte step in
V1_CASES = [(100_096, 12_500, 0), (1024, 97, 0), (1024, 97, 4),
            (100_096, 1, 4), (464_896, 3001, 8)]


def _v1_tiles(nt, m, seed, skip):
    view = _indices(nt, m * 128, seed, skip).view(m, 128)
    assert view.data_ptr() % 16 == 0
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("nt,m,skip", V1_CASES)
def test_cuda_take2d_matches_plain(nt, m, skip):
    """V1 bit-equal to `take2d_plain` in one launch, with positive load
    and select spans and at most a wave of blocks."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(nt + m)
    tab2d = torch.randint(0, 1 << 30, (nt // 128, 128), generator=gen,
                          device="cuda", dtype=torch.int32)
    idx2 = _v1_tiles(nt, m, 14, skip)
    cyc = torch.zeros(3, dtype=torch.int64, device="cuda")
    before = A.launch_counts["take2d"]
    got = A.take2d(tab2d, idx2, cycles=cyc)
    torch.cuda.synchronize()
    assert got.shape == idx2.shape
    assert torch.equal(got, A.take2d_plain(tab2d, idx2))
    assert A.launch_counts["take2d"] == before + 1
    load, select, blocks = cyc.tolist()
    assert load > 0 and select > 0
    assert 1 <= blocks <= 8 * torch.cuda.get_device_properties(
        0).multi_processor_count


@pytest.mark.cuda
def test_cuda_take2d_on_an_unaligned_table_and_tiles():
    """A table view one entry into its storage (4-byte loads of its rows);
    index tiles not 16-byte aligned are refused, not run some other
    way."""
    _needs_card()
    store = torch.arange(1024 + 1, dtype=torch.int32, device="cuda") * 5
    tab2d = store[1:].view(8, 128)
    assert tab2d.data_ptr() % 16
    idx2 = _v1_tiles(1024, 97, 16, 0)
    got = A.take2d(tab2d, idx2)
    torch.cuda.synchronize()
    assert torch.equal(got, A.take2d_plain(tab2d, idx2))
    flat = _indices(1024, 97 * 128, 17, 1)
    with pytest.raises(ValueError, match="16-byte"):
        A.take2d(tab2d, flat.view(97, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("skip,e", [(0, 1_600_000), (1, 12_345), (3, 3),
                                    (1, 0)])
def test_cuda_take_matches_plain(skip, e):
    """C1's `take` at the probe's n=100000, E=1.6M and ragged and offset
    indices: bit-equal to `take_plain`, one launch."""
    _needs_card()
    _take_run(100_000, _indices(100_000, e, 18, skip))


def _slab_run(nt, idx2, seed=0, **kw):
    """`take_axis0` (with its spans) on a fresh [nt / 128, 128] table,
    bit-equal to the plain version; the spans."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tab2d = torch.randint(0, 1 << 30, (nt // 128, 128), generator=gen,
                          device="cuda", dtype=torch.int32)
    cyc = torch.zeros(3, dtype=torch.int64, device="cuda")
    got = A.take_axis0(tab2d, idx2, cycles=cyc, **kw)
    ref = A.take_axis0_plain(tab2d, idx2)
    torch.cuda.synchronize()
    assert got.shape == idx2.shape and torch.equal(got, ref)
    return cyc.tolist()


def _tiles_at(nt, m, seed, skip=0):
    flat = _indices(nt, m * 128, seed, skip)
    return flat.view(m, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", A.SLAB_COLS)
def test_cuda_slab_take_axis0_matches_plain(cols):
    """V2 at n=100000 (nt=100096), M=12500 at each slab width: bit-equal,
    with positive spans and a whole number of groups of blocks."""
    _needs_card()
    stage, lookup, blocks = _slab_run(100_096, _tiles_at(100_000, 12_500,
                                                         cols), cols=cols)
    assert stage > 0 and lookup > 0 and blocks % (128 // cols) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("nt,m,skip", [(1024, 97, 0), (100_096, 1, 1),
                                       (100_096, 12_501, 3),
                                       (232_448, 3000, 0),
                                       (232_576, 3000, 2),
                                       (1_859_584, 2000, 0)])
def test_cuda_slab_take_axis0_ragged_offset_and_edges(nt, m, skip):
    """Ragged M, index tiles 1-3 elements past a 16-byte boundary, and
    the largest table of slabs of 32 columns, one row past it (16), and
    the largest of slabs of 4."""
    _needs_card()
    _slab_run(nt, _tiles_at(nt, m, 11, skip))


@pytest.mark.cuda
def test_cuda_slab_take_axis0_on_an_unaligned_table():
    """A table view one entry into its storage: staged by 4-byte copies."""
    _needs_card()
    store = torch.arange(100_096 + 1, dtype=torch.int32, device="cuda")
    tab2d = store[1:].view(-1, 128)
    assert tab2d.data_ptr() % 16
    idx2 = _tiles_at(100_096, 500, 12)
    got = A.take_axis0(tab2d, idx2)
    torch.cuda.synchronize()
    assert torch.equal(got, A.take_axis0_plain(tab2d, idx2))


@pytest.mark.cuda
@pytest.mark.parametrize("stream", list(cases.STREAMS))
def test_cuda_slab_take_axis0_hub_streams_match_plain(stream):
    """The hub streams' whole rows of 128: every lane of a row on one
    table row."""
    _needs_card()
    idx, _val = cases.hub_stream(stream, "cuda")
    rows = idx[:idx.numel() // 128 * 128].reshape(-1, 128)
    _slab_run(-(-cases.SIZE // 128) * 128, rows)


@pytest.mark.cuda
def test_cuda_take_axis0_refuses_a_table_past_its_plan():
    _needs_card()
    wide = torch.zeros((1_859_584 // 128 + 1, 128), dtype=torch.int32,
                       device="cuda")
    idx2 = _tiles_at(1000, 4, 13)
    with pytest.raises(ValueError, match="slabs of 4 columns hold at most"):
        A.take_axis0(wide, idx2)
    with pytest.raises(ValueError):
        A.take_axis0(wide[:1817], idx2, cols=32)


@pytest.mark.parametrize("name", A.KERNELS)
def test_access_cpu_tensors_take_the_plain_version(name):
    inp = P.make_inputs(1000, 777, 5, 1, "cpu", seed=3)
    kern, plain, args = P._calls(inp)[name]
    before = dict(A.launch_counts)
    got = kern(*args[0])
    assert got.dtype == torch.int32 and torch.equal(got, plain(*args[0]))
    assert A.launch_counts == before


@pytest.mark.parametrize("name", A.KERNELS)
def test_access_wrappers_never_fall_back_off_the_cpu(name):
    """A `meta` tensor never reaches the plain version: the wrapper
    raises. So does a wrong shape."""
    inp = P.make_inputs(1000, 777, 5, 1, "cpu", seed=3)
    kern, _plain, args = P._calls(inp)[name]
    moved = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                  for a in args[0])
    with pytest.raises(ValueError):
        kern(*moved)
    mixed = (args[0][0].to("meta"),) + tuple(args[0][1:])
    with pytest.raises(ValueError):
        kern(*mixed)
    given = args[0][0] if name.startswith("scatter_min") else args[0][1]
    bad = inp["idx2"][0] if given.dim() == 1 else inp["idx"][0]
    with pytest.raises(ValueError):
        if name.startswith("scatter_min"):
            kern(bad, bad, 1000)
        else:
            kern(args[0][0], bad)


@pytest.mark.cuda
@pytest.mark.parametrize("stream", list(cases.STREAMS))
def test_cuda_scatter_min_hub_streams_match_plain(stream):
    """Runs of one index up to 3000 long, a ragged E, E < 32, one index
    only, and views one element into their storage (a head of 3 updates
    before the first 16-byte boundary)."""
    _needs_card()
    idx, val = cases.hub_stream(stream, "cuda")
    got = A.scatter_min(idx, val, cases.SIZE)
    ref = A.scatter_min_plain(idx, val, cases.SIZE)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


# n, E, cluster size: each edge of the plan, tails of 1-3 entries in the
# last slice and in the index tile
SCALAR_CASES = [(1000, 8192, 1), (49_916, 8192, 1), (49_917, 8192, 2),
                (100_000, 8192, 2), (100_000, 13, 2), (108_025, 8191, 3),
                (456_672, 8192, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,blocks", SCALAR_CASES)
def test_cuda_take_scalar_cluster_matches_plain(n, e, blocks):
    """C3 bit-equal; the cycles buffer holds positive
    staging and walk spans and counts as remote exactly the indices past
    block 0's slice."""
    _needs_card()
    plan = A.scalar_plan(n, e)
    assert plan.blocks == blocks
    gen = torch.Generator(device="cuda").manual_seed(n + e)
    table = torch.randint(0, 1 << 30, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
    idx = torch.randint(0, n, (e,), generator=gen, device="cuda",
                        dtype=torch.int32)
    cyc = torch.zeros(3, dtype=torch.int64, device="cuda")
    got = A.take_scalar(table, idx, cycles=cyc)
    ref = A.take_plain(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    stage, walk, remote = cyc.tolist()
    assert stage > 0 and walk > 0
    assert remote == int((idx >= plan.head).sum())


@pytest.mark.cuda
def test_cuda_access_wrappers_refuse_unaligned_input():
    """The bulk copies of C3 need 16-byte aligned tensors, and C4's
    vector loads indices and values at one offset: refused, not run some
    other way."""
    _needs_card()
    table = torch.arange(1001, dtype=torch.int32, device="cuda")
    idx = torch.arange(1001, dtype=torch.int32, device="cuda") % 1000
    with pytest.raises(ValueError):
        A.take_scalar(table[1:], idx[:100])
    with pytest.raises(ValueError):
        A.take_scalar(table, idx[1:])
    with pytest.raises(ValueError):
        A.scatter_min(idx[1:900], idx[2:901], 1000)


def test_probe_entry_point_runs_on_the_cpu():
    """The entry point end to end at a small shape; on the CPU it times
    the plain versions with the host clock and says so."""
    lines = []
    res = P.run(1000, 4096, 2, device="cpu", emit=lines.append)
    assert res["device"] == "cpu" and res["timer"] == "host clock"
    assert set(res) >= {"kernels", "by_cluster", "by_slab", "read_rates"}
    assert "previous" not in res and set(res["kernels"]) == set(A.KERNELS)
    for row in res["kernels"].values():
        assert row["max_abs_err"] == 0 and row["launches"] == 0
        assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
    assert any(line.startswith("A1 ") for line in lines)
    # the cluster sweep: every size that holds the table, no card numbers
    assert set(res["by_cluster"]) == {"2", "4", "8"}
    assert all("clusters" not in row and row["ms"] > 0
               for row in res["by_cluster"].values())
    assert set(res["read_rates"]) == set(P.RATED)


@pytest.mark.parametrize("name", P.RATED)
def test_read_rates_split_a_launch_on_the_cpu(name):
    """Each rated lookup on twice the indices, bit-equal first: its fixed
    part and added time make up its two times."""
    inp = P.make_inputs(1000, 2048, 16, 3, "cpu", seed=9)
    row = P.read_rates(inp, {name: 1.0}, lambda s: None)[name]
    assert row["ms"] == 1.0 and row["ms_twice"] > 0
    added = row["ms_twice"] - row["ms"]
    assert row["fixed_ms"] == pytest.approx(row["ms"] - added)


def test_time_stream_runs_on_the_cpu():
    """`time_stream` on a hub stream: every kernel bit-equal to its plain
    version, and the atomics C4's merge leaves."""
    idx, val = cases.hub_stream("runs_to_3000")
    table = torch.arange(cases.SIZE, dtype=torch.int32) * 7
    res = P.time_stream(table, idx, idx, val, 2)
    assert res["max_abs_err"] == {name: 0 for name in A.KERNELS}
    assert res["scatter_min_reds"] == P.merged_reds(idx) == 183
    assert all(res[k] > 0 for k in ("scatter_min_ms", "take_scalar_ms"))


@pytest.mark.cuda
def test_cli_grace_launches_the_kernels_on_the_card(tmp_path, monkeypatch):
    """The recipe CLI with no device= trains GRACE on the card through the
    pair kernels (f = 32): a pair forward and two pair gradient launches
    an epoch, no one-way launch, at a ragged node count."""
    _needs_card()
    from rlap_tpu_torch.cli.run import run_one
    from rlap_tpu_torch.data import loaders as L
    from rlap_tpu_torch.utils.config import ExperimentConfig
    from rlap_tpu_torch.utils.logging import read_metrics

    monkeypatch.setitem(L._SYN_SHAPES, "CORA", (301, 4, 64))
    monkeypatch.setenv("RLAP_TPU_DATA", str(tmp_path / "no-datasets"))
    cfg = ExperimentConfig(recipe="grace", dataset="CORA", augmentor="rLap",
                           hidden_dim=32, max_epochs=3, tolerance=10)
    before = dict(K.launch_counts)
    run_one(cfg, results_dir=str(tmp_path))
    torch.cuda.synchronize()
    assert _launched(before) == _pair_launches(3, 6)
    recs = list(read_metrics(str(tmp_path / f"{cfg.run_name()}.jsonl")))
    (test_run,) = [r for r in recs if r["event"] == "test_run"]
    assert 0 <= test_run["accuracy"] <= 1
    loss = [r["value"] for r in recs if r.get("name") == "final_loss"]
    assert np.isfinite(loss).all()


@pytest.mark.cuda
def test_rlap_throughput_bench_on_the_card():
    """`rlap_throughput.run` at n=20000 on the card: every call removes
    n/2 nodes, the result holds bench.py's keys and names the card, and
    its traced call shows the card's work."""
    _needs_card()
    from rlap_tpu_torch.bench import rlap_throughput as RT

    res = RT.run(n=20000, reps=2)
    assert res["removed"] == 10000 and len(res["rounds"]) == 2
    assert res["metric"] == "rlap_edges_per_s" and res["unit"] == "edges/s"
    assert res["value"] > 0 and res["vs_baseline"] > 0
    assert len(res["oracle_s"]) == 5
    assert res["device"] == torch.cuda.get_device_name(0)
    assert res["card"].startswith(res["device"])
    assert 0 < res["roofline_fraction"] <= 1
    assert res["roofline_ms"] == pytest.approx(res["roofline_fraction"]
                                               * res["ms_per_call"])
    # the traced call ran its kernels on the card
    assert res["traced_call_kernels"] > 0
    assert 0 < res["traced_call_device_busy_ms"] <= res["traced_call_ms"]


@pytest.mark.cuda
def test_cuda_measure_prices_holds_take_and_scatter_min():
    """The roofline's prices on the card at a small E: C1 `take` and C4
    `scatter_min` bit-equal to their plain versions at E and 2E, launched
    for the checks and for every timed call (a warm-up and `reps` at each
    size), and five finite, positive prices."""
    _needs_card()
    reps = 5
    res = RL.measure_prices("cuda", n=100_000, e=1 << 18, reps=reps)
    assert res["max_abs_err"] == {"take": 0, "scatter_min": 0}
    assert res["launches"] == {"take": 2 + 2 * (reps + 1),
                               "scatter_min": 2 + 2 * (reps + 1)}
    assert set(res["prices_ns"]) == set(RL.PRICES)
    assert all(np.isfinite(v) and v > 0 for v in res["prices_ns"].values())
    assert res["device"] == torch.cuda.get_device_name(0)
    assert res["timer"] == "cuda events"
