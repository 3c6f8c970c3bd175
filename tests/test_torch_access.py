"""The eight access probes' CPU path against the `jax.numpy` expressions
that the TPU tools use as their own references (`tools/probe_access.py`
:156, :229, :269; `tools/probe_access2.py` :74, :121-124, :163, and the two
`take_along_axis` calls of `k_v4` run outside Pallas). The Pallas calls
themselves name `pltpu.VMEM` inside `main()` and cannot run on the CPU.
Integers: exact equality. Shapes: n = 1000 (not a multiple of 128) with
E = 4096 and with a ragged E = 12345, M = 97 index tiles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlap_tpu_torch.ops import access as A

N = 1000
NT = -(-N // 128) * 128
SHAPES = [(4096, 32), (12345, 97)]


def _inputs(e, m, seed=0):
    r = np.random.default_rng(seed)
    table = r.integers(0, 1 << 30, N).astype(np.int32)
    tpad = np.pad(table, (0, NT - N))
    return dict(table=table, tpad=tpad, tab2d=tpad.reshape(NT // 128, 128),
                idx=r.integers(0, N, e).astype(np.int32),
                val=r.integers(0, 1 << 20, e).astype(np.int32),
                idx2=r.integers(0, N, (m, 128)).astype(np.int32))


def _t(a):
    return torch.from_numpy(a)


def _same(got: torch.Tensor, ref):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("e,m", SHAPES)
def test_take_matches_jnp(e, m):
    d = _inputs(e, m)
    _same(A.take(_t(d["table"]), _t(d["idx"])),
          jnp.asarray(d["table"])[jnp.asarray(d["idx"])])


@pytest.mark.parametrize("e,m", SHAPES)
def test_take_two_level_matches_jnp(e, m):
    d = _inputs(e, m, 1)
    _same(A.take_two_level(_t(d["tab2d"]), _t(d["idx"])),
          jnp.asarray(d["tpad"])[jnp.asarray(d["idx"])])


@pytest.mark.parametrize("e,m", SHAPES)
def test_take_scalar_matches_jnp(e, m):
    d = _inputs(e, m, 2)
    tile = d["idx"][:min(e, 8192)]
    _same(A.take_scalar(_t(d["table"]), _t(tile)),
          jnp.asarray(d["table"])[jnp.asarray(tile)])


@pytest.mark.parametrize("e,m", SHAPES)
def test_scatter_min_matches_jnp(e, m):
    d = _inputs(e, m, 3)
    ref = jnp.full((NT,), 2 ** 30, jnp.int32).at[jnp.asarray(d["idx"])].min(
        jnp.asarray(d["val"]))
    got = A.scatter_min(_t(d["idx"]), _t(d["val"]), NT)
    _same(got, ref)
    assert int((got == A.FILL).sum()) >= NT - N  # untouched entries


@pytest.mark.parametrize("e,m", SHAPES)
def test_take2d_matches_jnp(e, m):
    d = _inputs(e, m, 4)
    ref = jnp.asarray(d["tpad"])[jnp.asarray(d["idx2"]).reshape(-1)]
    _same(A.take2d(_t(d["tab2d"]), _t(d["idx2"])), ref.reshape(m, 128))


@pytest.mark.parametrize("e,m", SHAPES)
def test_take_axis0_matches_numpy_reference(e, m):
    d = _inputs(e, m, 5)
    rows = d["idx2"] // 128
    cols = np.broadcast_to(np.arange(128), rows.shape)
    _same(A.take_axis0(_t(d["tab2d"]), _t(d["idx2"])), d["tab2d"][rows, cols])
    _same(A.take_axis0(_t(d["tab2d"]), _t(d["idx2"])),
          jnp.take_along_axis(jnp.asarray(d["tab2d"]), jnp.asarray(rows),
                              axis=0))


@pytest.mark.parametrize("e,m", SHAPES)
def test_take_axis1_matches_numpy_reference(e, m):
    d = _inputs(e, m, 6)
    _same(A.take_axis1(_t(d["tab2d"]), _t(d["idx2"])),
          d["tab2d"][0][d["idx2"] % 128])


@pytest.mark.parametrize("e,m", SHAPES)
def test_take_axis0_axis1_matches_jnp(e, m):
    d = _inputs(e, m, 7)
    idx = jnp.asarray(d["idx2"])
    byrow = jnp.take_along_axis(jnp.asarray(d["tab2d"]), idx // 128, axis=0)
    _same(A.take_axis0_axis1(_t(d["tab2d"]), _t(d["idx2"])),
          jnp.take_along_axis(byrow, idx % 128, axis=1))


def test_axis0_axis1_is_not_the_full_lookup():
    """The tool says so of V4: the value wanted lies in another lane."""
    d = _inputs(4096, 32, 8)
    full = A.take2d(_t(d["tab2d"]), _t(d["idx2"]))
    assert not torch.equal(A.take_axis0_axis1(_t(d["tab2d"]), _t(d["idx2"])),
                           full)


def test_wrappers_reject_wrong_shapes():
    d = _inputs(256, 2)
    table, tab2d = _t(d["table"]), _t(d["tab2d"])
    idx, idx2 = _t(d["idx"]), _t(d["idx2"])
    for fn, args in ((A.take, (tab2d, idx)), (A.take, (table, idx2)),
                     (A.take_two_level, (table, idx)),
                     (A.take_scalar, (table, idx2)),
                     (A.take2d, (tab2d, idx)), (A.take_axis0, (table, idx2)),
                     (A.take_axis1, (tab2d, idx2[:, :64])),
                     (A.take_axis0_axis1, (tab2d.reshape(-1, 64), idx2)),
                     (A.take, (table[:0], idx))):
        with pytest.raises(ValueError):
            fn(*args)
    with pytest.raises(ValueError):
        A.scatter_min(idx, _t(d["val"])[:10], NT)
    with pytest.raises(ValueError):
        A.scatter_min(idx, _t(d["val"]), 0)
