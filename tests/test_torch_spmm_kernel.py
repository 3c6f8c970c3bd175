"""`spmm`'s kernel path (`rlap_tpu_torch/ops/spmm.py`, `csrc/spmm.cu`).

On the CPU: the order `segment_order` sorts the edges into, against
numpy's stable argsort, on graphs with padding, duplicate edges,
self-loops, empty rows, edges to the sentinel and nothing but padding; the
kernel's function (a segment-sum over that order, in edge order, skipping
the sentinel) emulated in numpy against `spmm_plain`, forward and the
backward's two gradients; `spmm` against `spmm_plain` and the JAX
package's `spmm`, values and gradients; and CPU tensors taking the plain
path, with no launch.

On a card (`cuda`, skipped here): the kernel against `spmm_plain` at
widths 1, 3, 64, 128, 512 and 513 in float32 and float64, with both
gradients; rows of a few thousand edges, which a whole block sums; rows
that are not 16-byte aligned; the same bits from two calls; no fallback,
and a raise on bf16 and on a non-contiguous input. float32 within rtol
1e-5 / atol 1e-5 of `spmm_plain` (short rows of unit-scale products,
summed in another order than `index_add`'s), float64 within 1e-12; the
rows of 5000 edges against float64, within the bound of float32
summation in any order; at a width of several column tiles (f = n =
1063, odd, so 4-byte loads), forward and dx bit-equal to the same calls
on contiguous 128-column slices, on a graph with a row of 250 edges, one
of 300, empty rows and padding (float32 against float64 within the
summation bound, as the long rows), and the `spmm.tiled` counter one a
launch there and none at f = 128 and 512. This file imports JAX only inside
the test that compares with it, so on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_spmm_kernel.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from rlap_tpu_torch.core.graph import Graph
from rlap_tpu_torch.ops import spmm as S


def _edges(n, case, seed):
    """(senders, receivers, weights) as numpy arrays, padding interleaved
    with the live edges (sender == receiver == n, weight 0)."""
    r = np.random.default_rng(seed)
    live = {"all_padding": 0, "no_edges": 0}.get(case, 6 * n)
    s, d = r.integers(0, n, live), r.integers(0, n, live)
    if case == "empty_rows":            # only the first fifth of the rows
        d = r.integers(0, max(1, n // 5), live)
    if case == "duplicates":
        s, d = np.concatenate([s, s[:live // 2]]), \
            np.concatenate([d, d[:live // 2]])
    if case == "self_loops":
        s, d = np.concatenate([s, np.arange(n)]), \
            np.concatenate([d, np.arange(n)])
    if case == "sentinel_ends":         # live edges with one end at n
        s[:5], d[5:10] = n, n
    w = r.normal(size=s.shape[0])
    pad = 0 if case == "no_edges" else max(7, n // 3)
    s = np.concatenate([s, np.full(pad, n)])
    d = np.concatenate([d, np.full(pad, n)])
    w = np.concatenate([w, np.zeros(pad)])
    p = r.permutation(s.shape[0])
    return s[p], d[p], w[p]


CASES = ("padding", "duplicates", "self_loops", "empty_rows",
         "sentinel_ends", "all_padding", "no_edges")


def _graph(n, case, seed, dtype=torch.float64, device="cpu"):
    s, d, w = _edges(n, case, seed)
    return Graph(senders=torch.tensor(s, device=device),
                 receivers=torch.tensor(d, device=device),
                 weights=torch.tensor(w, dtype=dtype, device=device),
                 num_nodes=n)


def _order_ref(keys, other, n):
    perm = np.argsort(keys, kind="stable")
    return np.searchsorted(keys[perm], np.arange(n + 2)), perm, other[perm]


def _segment_sum_ref(x, keys, other, w, n):
    """The kernel's function over `segment_order`, in numpy, row by row
    in edge order; an edge that gathers the sentinel adds nothing."""
    rowptr, perm, col = (t.numpy() for t in S.segment_order(
        torch.tensor(keys), torch.tensor(other), n))
    out = np.zeros_like(x)
    for i in range(n):
        for k in range(rowptr[i], rowptr[i + 1]):
            if col[k] < n:
                out[i] += w[perm[k]] * x[col[k]]
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("by", ["receivers", "senders"])
def test_segment_order_matches_numpy(case, by):
    n = 40
    s, d, _ = _edges(n, case, seed=len(case))
    keys, other = (d, s) if by == "receivers" else (s, d)
    rowptr, perm, col = S.segment_order(torch.tensor(keys),
                                        torch.tensor(other), n)
    ref_ptr, ref_perm, ref_col = _order_ref(keys, other, n)
    assert rowptr.dtype == col.dtype == torch.int32
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(rowptr.numpy(), ref_ptr)
    np.testing.assert_array_equal(perm.numpy(), ref_perm)
    np.testing.assert_array_equal(col.numpy(), ref_col)
    # every padding slot lies in segment n, which the kernel never visits
    pad = (s == n) & (d == n)
    assert np.all(np.isin(np.flatnonzero(pad),
                          ref_perm[ref_ptr[n]:ref_ptr[n + 1]]))
    assert rowptr[-1] == keys.shape[0]


def test_segment_order_refuses_what_int32_cannot_hold():
    keys = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError):
        S.segment_order(keys, keys, 2**31 - 1)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("f", [1, 5])
def test_the_kernels_function_over_the_order_is_spmm_plain(case, f):
    """Forward (segments by receiver) and the backward's dx (the output's
    gradient gathered by receiver into segments by sender) and d(weights)
    (per-edge dots) as `_SpMM` computes them, against autograd through
    `spmm_plain`, in float64."""
    n = 30
    g = _graph(n, case, seed=f + len(case))
    r = np.random.default_rng(f)
    x = torch.tensor(r.normal(size=(n, f)), requires_grad=True)
    w = g.weights.clone().requires_grad_(True)
    gy = r.normal(size=(n, f))
    out = S.spmm_plain(g, x, w)
    (out * torch.tensor(gy)).sum().backward()
    s, d = g.senders.numpy(), g.receivers.numpy()
    wn = w.detach().numpy()
    np.testing.assert_allclose(
        _segment_sum_ref(x.detach().numpy(), d, s, wn, n),
        out.detach().numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_segment_sum_ref(gy, s, d, wn, n),
                               x.grad.numpy(), rtol=1e-12, atol=1e-12)
    dw = (S._pad_row(x.detach())[g.senders]
          * S._pad_row(torch.tensor(gy))[g.receivers]).sum(-1)
    np.testing.assert_allclose(dw.numpy(), w.grad.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("case", ["padding", "duplicates", "empty_rows"])
def test_spmm_and_its_gradients_match_plain_and_jax(case):
    import jax
    import jax.numpy as jnp

    from rlap_tpu.core.graph import Graph as JGraph
    from rlap_tpu.ops.spmm import spmm as j_spmm

    n, f = 50, 16
    g = _graph(n, case, seed=3, dtype=torch.float32)
    r = np.random.default_rng(4)
    xn = r.normal(size=(n, f)).astype(np.float32)
    gy = r.normal(size=(n, f)).astype(np.float32)
    grads = []
    for fn in (S.spmm, lambda g, x, w: S.spmm_plain(g, x, w)):
        x = torch.tensor(xn, requires_grad=True)
        w = g.weights.clone().requires_grad_(True)
        out = fn(g, x, w)
        (out * torch.tensor(gy)).sum().backward()
        grads.append((out.detach(), x.grad, w.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)

    jg = JGraph(senders=jnp.asarray(g.senders.numpy(), jnp.int32),
                receivers=jnp.asarray(g.receivers.numpy(), jnp.int32),
                weights=jnp.asarray(g.weights.numpy()), num_nodes=n)

    def loss(x, w):
        return (j_spmm(jg, x, edge_weights=w) * gy).sum()

    jout = j_spmm(jg, jnp.asarray(xn), edge_weights=jg.weights)
    jdx, jdw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xn), jg.weights)
    for got, ref in zip(grads[0], (jout, jdx, jdw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call reached the kernel's launcher")

    monkeypatch.setattr(S._build, "launch", refuse)
    before = dict(S.launch_counts)
    g = _graph(20, "padding", seed=5, dtype=torch.float32)
    x = torch.randn(20, 8, requires_grad=True)
    out = S.spmm(g, x)
    out.sum().backward()
    assert torch.equal(out, S.spmm_plain(g, x))
    assert S.launch_counts == before
    # bf16 and strided inputs are the plain path's on the CPU
    S.spmm(g, torch.randn(20, 8, dtype=torch.bfloat16))
    S.spmm(g, torch.randn(8, 20).T)


def test_mixed_devices_raise():
    g = _graph(10, "padding", seed=6, dtype=torch.float32)
    with pytest.raises(ValueError):
        S.spmm(g.replace(weights=g.weights.to("meta")), torch.randn(10, 4))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


def _tol(dtype):
    return (1e-5, 1e-5) if dtype == torch.float32 else (1e-12, 1e-12)


def _both(g, xn, gy, dtype):
    """(out, dx, dw) of the kernel and of `spmm_plain`, on the card."""
    res = []
    for fn in (S.spmm, S.spmm_plain):
        x = torch.tensor(xn, dtype=dtype, device="cuda", requires_grad=True)
        w = g.weights.clone().requires_grad_(True)
        out = fn(g, x, w)
        (out * torch.tensor(gy, dtype=dtype, device="cuda")).sum().backward()
        res.append((out.detach(), x.grad, w.grad))
    torch.cuda.synchronize()
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("f", [1, 3, 64, 128, 512, 513])
def test_cuda_kernel_matches_plain(f, dtype):
    _needs_card()
    n = 3000
    g = _graph(n, "sentinel_ends", seed=f, dtype=torch.float32,
               device="cuda")
    r = np.random.default_rng(f)
    before = dict(S.launch_counts)
    got, ref = _both(g, r.normal(size=(n, f)), r.normal(size=(n, f)), dtype)
    rtol, atol = _tol(dtype)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
    assert S.launch_counts["spmm_fwd"] == before["spmm_fwd"] + 1
    assert S.launch_counts["spmm_bwd"] == before["spmm_bwd"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 128, 512])
def test_cuda_kernel_rows_longer_than_a_block(f):
    """Node 0 receives and sends 5000 edges: a row of the forward and one
    of the backward far longer than the 256 threads of a block."""
    _needs_card()
    n, hub = 2000, 5000
    r = np.random.default_rng(f)
    s = np.concatenate([r.integers(0, n, hub), np.zeros(hub, np.int64),
                        r.integers(0, n, 4 * n), np.full(99, n)])
    d = np.concatenate([np.zeros(hub, np.int64), r.integers(0, n, hub),
                        r.integers(0, n, 4 * n), np.full(99, n)])
    w = np.where(s < n, r.normal(size=s.shape[0]), 0.0)
    g = Graph(senders=torch.tensor(s, device="cuda"),
              receivers=torch.tensor(d, device="cuda"),
              weights=torch.tensor(w, dtype=torch.float32, device="cuda"),
              num_nodes=n)
    xn, gy = r.normal(size=(n, f)), r.normal(size=(n, f))
    got, _ = _both(g, xn, gy, torch.float32)
    _assert_float32_bound(g, xn, gy, w, got, hub + 1)


def _assert_float32_bound(g, xn, gy, w, got, m):
    """`got` (the float32 kernel path's out, dx and d(weights)) against
    float64, within the bound of any order of m float32 additions of these
    products, the inputs and each product rounded to float32 on the way:
    |err| <= (m + 3) 2^-24 sum |product| (m: the longest row for out and
    dx, f for the per-edge dots of d(weights))."""
    ref, bnd = [], []
    for vals in ((xn, gy, w), (np.abs(xn), np.abs(gy), np.abs(w))):
        x = torch.tensor(vals[0], device="cuda", requires_grad=True)
        wt = torch.tensor(vals[2], device="cuda", requires_grad=True)
        out = S.spmm_plain(g, x, wt)
        (out * torch.tensor(vals[1], device="cuda")).sum().backward()
        (ref if vals[0] is xn else bnd).extend(
            [out.detach(), x.grad, wt.grad])
    for a, b, mm, terms in zip(got, ref, (m, m, xn.shape[1]), bnd):
        assert bool(((a.double() - b).abs()
                     <= (mm + 3) * 2.0**-24 * terms).all())


@pytest.mark.cuda
def test_cuda_kernel_takes_rows_that_are_not_16_byte_aligned():
    """A contiguous view one float into its storage: the 16-byte loads do
    not apply, and the 4-byte path must give the same values."""
    _needs_card()
    n, f = 1000, 128
    g = _graph(n, "padding", seed=8, dtype=torch.float32, device="cuda")
    buf = torch.randn(n * f + 1, device="cuda")
    x = buf[1:].view(n, f)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    torch.testing.assert_close(S.spmm(g, x), S.spmm_plain(g, x),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 128, 512])
def test_cuda_kernel_gives_the_same_bits_twice(f):
    _needs_card()
    n = 5000
    g = _graph(n, "duplicates", seed=9, dtype=torch.float32, device="cuda")
    r = np.random.default_rng(9)
    xn, gy = r.normal(size=(n, f)), r.normal(size=(n, f))
    runs = [_both(g, xn, gy, torch.float32)[0] for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_spmm_never_falls_back_and_refuses_what_it_cannot_take(
        monkeypatch):
    _needs_card()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA call reached spmm_plain")

    n = 100
    g = _graph(n, "padding", seed=10, dtype=torch.float32, device="cuda")
    x = torch.randn(n, 32, device="cuda")
    ref = S.spmm_plain(g, x)
    monkeypatch.setattr(S, "spmm_plain", refuse)
    before = S.launch_counts["spmm_fwd"]
    torch.testing.assert_close(S.spmm(g, x), ref, rtol=1e-5, atol=1e-5)
    assert S.launch_counts["spmm_fwd"] == before + 1
    with pytest.raises(ValueError):
        S.spmm(g, x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        S.spmm(g, torch.randn(32, n, device="cuda").T)
    with pytest.raises(ValueError):
        S.spmm(g, x.cpu())


def _tiled_graph(n, dtype):
    """Node 0 receives and node 2 sends 250 edges (a row just under the 256
    a block's warps split), node 1 receives and node 3 sends 300, and no
    other edge touches nodes 0-3; nodes [n // 2, n) receive nothing and
    send nothing; 40 padding slots."""
    r = np.random.default_rng(n)
    half = n // 2
    rest = 3 * n
    s = np.concatenate([r.integers(4, half, 550), np.full(250, 2),
                        np.full(300, 3), r.integers(4, half, rest),
                        np.full(40, n)])
    d = np.concatenate([np.zeros(250, np.int64), np.ones(300, np.int64),
                        r.integers(4, half, 550), r.integers(4, half, rest),
                        np.full(40, n)])
    w = np.where(s < n, r.normal(size=s.shape[0]), 0.0)
    p = r.permutation(s.shape[0])
    return Graph(senders=torch.tensor(s[p], device="cuda"),
                 receivers=torch.tensor(d[p], device="cuda"),
                 weights=torch.tensor(w[p], dtype=dtype, device="cuda"),
                 num_nodes=n)


def _fwd_dx(g, x, gy):
    """`spmm`'s output and dx, and the `spmm.tiled` count of the two
    launches, under a profiler."""
    from rlap_tpu_torch.utils import tracing

    tracing.counters()
    xx = x.detach().clone().requires_grad_(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = S.spmm(g, xx)
        out.backward(gy)
        torch.cuda.synchronize()
    return out.detach(), xx.grad, tracing.counters().get("spmm.tiled")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_wider_than_a_tile_is_its_slices_bit_for_bit(dtype):
    """f = n = 1063 (the PPR series' product, S over T, at a small n): the
    launch spans 9 column tiles of 128 and each of its rows is split over
    them; forward and dx equal, bit for bit, the concatenation of calls on
    the contiguous 128-column slices (and the 39-column rest), each a
    launch of one tile. float64 within 1e-12 of `spmm_plain`; float32, with
    rows of 250 and 300 edges, within the float32 summation bound the rows
    of 5000 edges are held to."""
    _needs_card()
    n = f = 1063
    g = _tiled_graph(n, dtype)
    live = g.senders < n
    indeg = torch.bincount(g.receivers[live], minlength=n)
    outdeg = torch.bincount(g.senders[live], minlength=n)
    assert indeg[:2].tolist() == [250, 300]
    assert outdeg[2:4].tolist() == [250, 300]
    assert int(indeg[2:].max()) <= 256 and int(outdeg[4:].max()) <= 256
    r = np.random.default_rng(11)
    x = torch.tensor(r.normal(size=(n, f)), dtype=dtype, device="cuda")
    gy = torch.tensor(r.normal(size=(n, f)), dtype=dtype, device="cuda")
    out, dx, tiled = _fwd_dx(g, x, gy)
    assert tiled == 2.0
    parts = [_fwd_dx(g, x[:, c:c + 128].contiguous(),
                     gy[:, c:c + 128].contiguous())
             for c in range(0, f, 128)]
    assert all(t == 0.0 for _, _, t in parts)
    assert torch.equal(out, torch.cat([p[0] for p in parts], 1))
    assert torch.equal(dx, torch.cat([p[1] for p in parts], 1))
    xn, gn = x.cpu().numpy(), gy.cpu().numpy()
    got, ref = _both(g, xn, gn, dtype)
    assert torch.equal(got[0], out) and torch.equal(got[1], dx)
    if dtype == torch.float64:
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    else:   # rows of 300 edges: the bound of float32 summation
        _assert_float32_bound(g, xn, gn, g.weights.double().cpu().numpy(),
                              got, 301)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [128, 512])
def test_cuda_kernel_launches_one_tile_at_the_encoders_widths(f):
    """The encoders' widths fit one warp's tile: no launch counts as
    tiled, forward or dx."""
    _needs_card()
    n = 3000
    g = _graph(n, "sentinel_ends", seed=f, dtype=torch.float32,
               device="cuda")
    x = torch.randn(n, f, device="cuda")
    assert S.column_tiles(x, torch.empty_like(x)) == 1
    assert _fwd_dx(g, x, torch.randn(n, f, device="cuda"))[2] == 0.0
