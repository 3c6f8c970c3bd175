"""The eight access probes' CPU path against the `jax.numpy` expressions
that the TPU tools use as their own references (`tools/probe_access.py`
:156, :229, :269; `tools/probe_access2.py` :121-124, :163, and the two
`take_along_axis` calls of `k_v4` run outside Pallas). The tools' Pallas
calls name `pltpu.VMEM` inside `main()` and cannot run on the CPU. V1 is
held to what its kernel `k_v1` computes (`tools/probe_access2.py:85-92`):
its body as a `jax.numpy` expression, and a copy of it run through
`pl.pallas_call(interpret=True)` without `memory_space`.
Integers: exact equality. Shapes: n = 1000 (not a multiple of 128) with
E = 4096 and with a ragged E = 12345, M = 97 index tiles; the scatter-mins
also on hub-heavy streams (`tests/test_torch_access_cases.py`: sorted runs of
one index up to 3000 long, E not a multiple of 4, E < 32, one index only,
views one element into their storage). Beside them, what the redesigned
C3 and C4 compute in Python: the cluster plan of `take_scalar`, the
vector split of `scatter_min`, the atomics its merge leaves, and the
inputs both wrappers refuse; and the steps of the V1 and V2 kernels,
emulated in numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_access_cases as cases
from jax.experimental import pallas as pl

from rlap_tpu_torch.bench import probe_access as P
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


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("skip", [1, 2, 3])
@pytest.mark.parametrize("e,m", SHAPES)
def test_take_on_views_matches_jnp(e, m, skip):
    """C1 takes its table and its indices at any offset from a 16-byte
    boundary."""
    d = _inputs(e, m, 18)
    idx = d["idx"] % (N - skip)
    table, view = _t(d["table"])[skip:], _t(idx)[skip:]
    assert table.data_ptr() % 16 and view.data_ptr() % 16
    _same(A.take(table, view),
          jnp.asarray(d["table"][skip:])[jnp.asarray(idx[skip:])])


@pytest.mark.parametrize("name", list(cases.STREAMS))
def test_take_hub_streams_match_jnp(name):
    """Runs of one index up to 3000 long, one index only, E < 32 and a
    view one element into its storage."""
    idx, _val = cases.hub_stream(name)
    table = np.random.default_rng(13).integers(0, 1 << 30, cases.SIZE
                                               ).astype(np.int32)
    _same(A.take(torch.from_numpy(table), idx),
          jnp.asarray(table)[jnp.asarray(idx.numpy())])


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


# V1's kernel as `tools/probe_access2.py:85-91` writes it
def k_v1(tab_ref, idx_ref, out_ref):
    idx = idx_ref[:]
    rows = idx // 128
    lanes = idx % 128
    sel = jnp.take(tab_ref[:], rows.reshape(-1), axis=0)
    sel = sel.reshape(idx.shape[0], 128, 128)  # wrong-dim guard
    out_ref[:] = jnp.take_along_axis(sel[:, 0, :], lanes, axis=1)


TR = 32  # index rows a grid step of the Pallas run takes


def _k_v1_jnp(tab2d, idx2):
    """`k_v1`'s body as a `jax.numpy` expression: the table row of every
    index, `sel[:, 0, :]`, then the lanes."""
    idx = jnp.asarray(idx2)
    sel = jnp.take(jnp.asarray(tab2d), (idx // 128).reshape(-1), axis=0)
    sel = sel.reshape(idx.shape[0], 128, 128)
    return jnp.take_along_axis(sel[:, 0, :], idx % 128, axis=1)


def _k_v1_interpret(tab2d, idx2):
    """`k_v1` through `pl.pallas_call(interpret=True)` on the CPU: the
    table whole as one (R, 128) block, the index tiles in (TR, 128)
    blocks, as `try_variant` lays them out, but without
    `memory_space=pltpu.VMEM`, which does not run here. A grid step takes
    whole blocks, so M is padded with zero rows up to a multiple of TR for
    this run only and the result cut back: M = 97 stays tested."""
    m, r = idx2.shape[0], tab2d.shape[0]
    mp = -(-m // TR) * TR
    padded = np.zeros((mp, 128), np.int32)
    padded[:m] = idx2
    out = pl.pallas_call(
        k_v1, out_shape=jax.ShapeDtypeStruct((mp, 128), jnp.int32),
        grid=(mp // TR,),
        in_specs=[pl.BlockSpec((r, 128), lambda i: (0, 0)),
                  pl.BlockSpec((TR, 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((TR, 128), lambda i: (i, 0)),
        interpret=True)(jnp.asarray(tab2d), jnp.asarray(padded))
    return np.asarray(out)[:m]


@pytest.mark.parametrize("e,m", SHAPES)
def test_take2d_matches_jnp(e, m):
    """V1 against (a) `k_v1`'s body as a `jax.numpy` expression and (b)
    `k_v1` itself under the Pallas interpreter."""
    d = _inputs(e, m, 4)
    got = A.take2d(_t(d["tab2d"]), _t(d["idx2"]))
    _same(got, _k_v1_jnp(d["tab2d"], d["idx2"]))
    _same(got, _k_v1_interpret(d["tab2d"], d["idx2"]))
    _same(A.take2d_plain(_t(d["tab2d"]), _t(d["idx2"])), got)


@pytest.mark.parametrize("n,m", [(128, 1), (128, 33), (3000, 5), (3000, 64),
                                 (100_000, 1), (100_000, 40)])
def test_take2d_matches_k_v1_at_other_sizes(n, m):
    """One table row, a few and the probe's 782: V1 against both forms of
    `k_v1`."""
    r = np.random.default_rng(19)
    nt = -(-n // 128) * 128
    tab2d = np.pad(r.integers(0, 1 << 30, n).astype(np.int32),
                   (0, nt - n)).reshape(-1, 128)
    idx2 = r.integers(0, n, (m, 128)).astype(np.int32)
    got = A.take2d(_t(tab2d), _t(idx2))
    _same(got, _k_v1_jnp(tab2d, idx2))
    _same(got, _k_v1_interpret(tab2d, idx2))


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
    """The tool says so of V4: the value wanted lies in another lane. Nor
    is V1 under `k_v1`'s function: the row is each index row's first."""
    d = _inputs(4096, 32, 8)
    full = A.take_two_level(_t(d["tab2d"]),
                            _t(d["idx2"]).reshape(-1)).view(32, 128)
    _same(full, jnp.asarray(d["tpad"])[jnp.asarray(d["idx2"])])
    assert not torch.equal(A.take_axis0_axis1(_t(d["tab2d"]), _t(d["idx2"])),
                           full)
    assert not torch.equal(A.take2d(_t(d["tab2d"]), _t(d["idx2"])), full)


def test_wrappers_reject_wrong_shapes():
    d = _inputs(256, 2)
    table, tab2d = _t(d["table"]), _t(d["tab2d"])
    idx, idx2 = _t(d["idx"]), _t(d["idx2"])
    for fn, args in ((A.take, (tab2d, idx)), (A.take, (table, idx2)),
                     (A.take_two_level, (table, idx)),
                     (A.take_scalar, (table, idx2)),
                     (A.take2d, (tab2d, idx)),
                     (A.take_axis0, (table, idx2)),
                     (A.take_axis1, (tab2d, idx2[:, :64])),
                     (A.take_axis0_axis1, (tab2d.reshape(-1, 64), idx2)),
                     (A.take, (table[:0], idx))):
        with pytest.raises(ValueError):
            fn(*args)
    with pytest.raises(ValueError):
        A.scatter_min(idx, _t(d["val"])[:10], NT)
    with pytest.raises(ValueError):
        A.scatter_min(idx, _t(d["val"]), 0)


@pytest.mark.parametrize("fn", [A.scatter_min])
@pytest.mark.parametrize("name", list(cases.STREAMS))
def test_scatter_min_hub_streams_match_jnp(name, fn):
    idx, val = cases.hub_stream(name)
    ref = jnp.full((cases.SIZE,), 2 ** 30, jnp.int32).at[
        jnp.asarray(idx.numpy())].min(jnp.asarray(val.numpy()))
    _same(fn(idx, val, cases.SIZE), ref)


@pytest.mark.parametrize("name,reds", [("all_equal", 41), ("e_below_32", 10),
                                       ("runs_to_3000", 183)])
def test_merged_atomics_of_hub_streams(name, reds):
    """One hub of 5001 updates: a red for each warp's 32 quads (40 warps)
    and one for the tail update. Runs leave at least one each, and fewer
    than their updates."""
    idx, _val = cases.hub_stream(name)
    assert P.merged_reds(idx) == reds
    runs = int((idx[1:] != idx[:-1]).sum()) + 1
    assert runs <= reds < idx.numel()


def test_merged_atomics_of_distinct_indices():
    """Without repeats no update merges: one atomic each, head and tail
    included."""
    store = torch.randperm(4000, generator=torch.Generator().manual_seed(0))
    idx = store.to(torch.int32)[3:3 + 2001]
    assert A.vector_split(idx.data_ptr(), 2001)[0] == 1
    assert P.merged_reds(idx) == 2001


@pytest.mark.parametrize("offset,e,split", [(0, 10, (0, 2)), (4, 10, (3, 1)),
                                            (8, 2, (2, 0)), (12, 7, (1, 1)),
                                            (0, 3, (0, 0))])
def test_vector_split(offset, e, split):
    head, quads = A.vector_split(0x7f00 + offset, e)
    assert (head, quads) == split
    assert 0 <= e - head - 4 * quads < 4


@pytest.mark.parametrize("n,blocks", [(1, 1), (1000, 1), (49_916, 1),
                                      (49_917, 2), (100_000, 2),
                                      (108_024, 2), (108_025, 3),
                                      (456_672, 8)])
def test_scalar_plan_edges(n, blocks):
    """k = 1, 2 and 8 at the edges of each step, for a full tile of
    indices: block 0 holds 49916 entries beside them, the others 58108."""
    plan = A.scalar_plan(n, A.TILE)
    assert plan.blocks == blocks
    assert plan.smem <= A.SMEM_BLOCK
    if blocks == 1:
        assert plan.head == n
        return
    assert plan.head == 49_916 and plan.head % 4 == 0 and plan.slice % 4 == 0
    assert plan.slice <= 58_108
    assert plan.head + (blocks - 2) * plan.slice < n
    assert plan.head + (blocks - 1) * plan.slice >= n
    # block 0: its barrier, its slice and the index tile
    assert plan.smem >= A.BARRIER_BYTES + 4 * plan.head + 4 * A.TILE


def test_scalar_plan_raises_beyond_a_cluster():
    with pytest.raises(ValueError, match="at most 8"):
        A.scalar_plan(456_673, A.TILE)
    with pytest.raises(ValueError):
        A.scalar_plan(1000, A.TILE + 1)
    # a shorter tile leaves block 0 more room
    assert A.scalar_plan(456_673, 4096).blocks == 8


def test_take_scalar_rejects_unaligned_or_oversized_input():
    d = _inputs(4096, 32)
    table, idx = _t(d["table"]), _t(d["idx"])
    assert table.data_ptr() % 16 == 0 and idx.data_ptr() % 16 == 0
    for bad in ((table[1:], idx), (table, idx[1:]),
                (table, torch.zeros(A.TILE + 1, dtype=torch.int32)),
                (torch.zeros(500_000, dtype=torch.int32), idx)):
        with pytest.raises(ValueError):
            A.take_scalar(*bad)
    with pytest.raises(ValueError, match="card"):
        A.take_scalar(table, idx, cycles=torch.zeros(3, dtype=torch.int64))


def test_scatter_min_rejects_unaligned_or_oversized_input():
    d = _inputs(4096, 32, 9)
    idx, val = _t(d["idx"]), _t(d["val"])
    with pytest.raises(ValueError, match="16-byte"):
        A.scatter_min(idx[1:4001], val[2:4002], NT)
    with pytest.raises(ValueError, match="int32"):
        A.scatter_min(idx, val, 2 ** 31)


# C2: the cluster-resident table. The largest table (a multiple of
# 128 entries) that k blocks hold: 58,108 entries a block
TABLE_EDGES = {1: 57_984, 2: 116_096, 3: 174_208, 4: 232_320, 5: 290_432,
               6: 348_544, 7: 406_656, 8: 464_768}


@pytest.mark.parametrize("blocks,edge", sorted(TABLE_EDGES.items()))
def test_table_plan_edges(blocks, edge):
    """k blocks hold the edge table and not one row more; where the
    default cluster cannot, the plan takes the fewest blocks that can."""
    plan = A.table_plan(edge, blocks)
    assert plan.blocks == blocks and plan.smem <= A.SMEM_BLOCK
    with pytest.raises(ValueError, match="does not fit a cluster"):
        A.table_plan(edge + 128, blocks)
    assert A.table_plan(edge).blocks == max(A.CLUSTER_DEFAULT, blocks)
    if blocks < A.CLUSTER_MAX:
        assert A.table_plan(edge + 128).blocks == \
            max(A.CLUSTER_DEFAULT, blocks + 1)


@pytest.mark.parametrize("nt", [128, 1024, 100_096, 150_016, 464_768])
@pytest.mark.parametrize("blocks", [1, 2, 3, 4, 7, 8])
def test_table_plan_slices_cover_the_table(nt, blocks):
    """Equal slices of whole 16-byte units, each block holding some of
    the table and the blocks all of it; the stage is the mbarrier and the
    slice."""
    if not A.table_fits(nt, blocks):
        with pytest.raises(ValueError):
            A.table_plan(nt, blocks)
        return
    plan = A.table_plan(nt, blocks)
    assert plan.slice % 4 == 0
    assert (blocks - 1) * plan.slice < nt <= blocks * plan.slice
    assert plan.smem == A.BARRIER_BYTES + 4 * plan.slice


def test_table_plan_raises_beyond_a_cluster():
    with pytest.raises(ValueError, match=r"1 to 8 blocks.*464864 entries"):
        A.table_plan(464_896)
    for blocks in (0, 9):
        with pytest.raises(ValueError):
            A.table_plan(1024, blocks)
    with pytest.raises(ValueError):
        A.table_plan(0)


def test_cluster_wrappers_refuse_a_table_beyond_a_cluster():
    """On the CPU too: both devices take the same inputs. V4, which reads
    its table from L2, takes a table of any size."""
    tab2d = torch.zeros((464_896 // 128, 128), dtype=torch.int32)
    idx = torch.arange(0, 464_896, 97, dtype=torch.int32)
    idx2 = torch.arange(0, 464_896, 3632, dtype=torch.int32).view(1, 128)
    with pytest.raises(ValueError, match="does not fit a cluster"):
        A.take_two_level(tab2d, idx)
    assert torch.equal(A.take_axis0_axis1(tab2d, idx2),
                       torch.zeros_like(idx2))
    # the largest table a cluster holds is taken
    A.take_two_level(tab2d[:464_768 // 128], idx % 464_768)


@pytest.mark.parametrize("e,m", SHAPES)
def test_axis0_axis1_shuffle_identity_matches_jnp(e, m):
    """V4's function in the form out[i, j] = tab2d[idx[i, L] // 128, L]
    with L = idx[i, j] % 128, against the tool's two `take_along_axis`
    calls (`tools/probe_access2.py:115-120`'s expression)."""
    d = _inputs(e, m, 10)
    idx2, tab2d = _t(d["idx2"]), _t(d["tab2d"])
    lanes = (idx2 % 128).long()
    rows_at = torch.take_along_dim(idx2, lanes, 1).long() // 128
    got = tab2d.reshape(-1)[rows_at * 128 + lanes]
    idx = jnp.asarray(d["idx2"])
    byrow = jnp.take_along_axis(jnp.asarray(d["tab2d"]), idx // 128, axis=0)
    _same(got, jnp.take_along_axis(byrow, idx % 128, axis=1))
    _same(A.take_axis0_axis1(tab2d, idx2), got)


def test_cluster_wrappers_take_their_options_on_the_cpu():
    """A cluster size runs the plain version on the CPU; a cycles buffer
    and a table not 16-byte aligned are refused there as on the card."""
    d = _inputs(4096, 32, 11)
    tab2d, idx, idx2 = _t(d["tab2d"]), _t(d["idx"]), _t(d["idx2"])
    ref = jnp.asarray(d["tpad"])[jnp.asarray(d["idx"])]
    for blocks in (None, 1, 2, 8):
        _same(A.take_two_level(tab2d, idx, blocks=blocks), ref)
    # indices at any offset
    _same(A.take_two_level(tab2d, idx[1:4094]), ref[1:4094])
    with pytest.raises(ValueError, match="card"):
        A.take_two_level(tab2d, idx, cycles=torch.zeros(3, dtype=torch.int64))
    flat = torch.zeros(NT + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="16-byte"):
        A.take_two_level(flat[1:].view(-1, 128), idx)


# V1's warps and V2's column slabs: the plans, and what the kernels
# compute, emulated step by step in numpy against the tools' references.

def _warp_take2d(tab2d, idx2, warps):
    """V1's kernel in numpy: warp w takes rows w, w + warps, ..., with the
    next row's indices loaded before the current row's select; lane 0's
    first index names the table row, which the warp stages whole, and each
    lane selects its quad's four lanes from the stage. Returns the output
    and how often each row was written."""
    m = idx2.shape[0]
    quads = idx2.reshape(m, 32, 4)
    out = np.full_like(idx2, -1)
    writes = np.zeros(m, np.int64)
    for w in range(min(warps, m)):
        i, j = w, quads[w]
        while i < m:
            stage = tab2d[j[0, 0] >> 7].copy()  # lane 0's index, shuffled
            ni = i + warps
            nxt = quads[ni] if ni < m else None
            out[i] = stage[j & 127].reshape(-1)
            writes[i] += 1
            i, j = ni, nxt
    return out, writes


def _v1_warps(m, sms=132):
    """The warps `access_take2d` launches on an H100 SXM's 132 SMs: blocks
    of 8 warps, one wave of them at most (8 blocks of 256 threads an SM),
    no more than the rows need."""
    return min(-(-m // 8), sms * 8) * 8


@pytest.mark.parametrize("warps", [1, 3, 8, 1056])
@pytest.mark.parametrize("e,m", SHAPES)
def test_take2d_warp_emulation_matches_jnp(e, m, warps):
    d = _inputs(e, m, 20)
    got, writes = _warp_take2d(d["tab2d"], d["idx2"], warps)
    assert (writes == 1).all()
    _same(torch.from_numpy(got), _k_v1_jnp(d["tab2d"], d["idx2"]))


@pytest.mark.parametrize("m", [1, 7, 8, 9, 97, 8447, 8448, 8449, 12_500])
def test_take2d_grid_covers_every_row_once(m):
    """The launch's grid at one row, a block's 8 rows and their edges, one
    whole wave (8448 warps on 132 SMs) and its edges, and the probe's
    12500 rows: every row written once, by the warps that stride over
    them."""
    warps = _v1_warps(m)
    assert warps >= min(m, 8448) and warps <= 8448
    d = _inputs(128, 1, 21)
    idx2 = np.random.default_rng(m).integers(0, N, (m, 128)).astype(np.int32)
    got, writes = _warp_take2d(d["tab2d"], idx2, warps)
    assert (writes == 1).all()
    _same(torch.from_numpy(got), A.take2d_plain(_t(d["tab2d"]), _t(idx2)))


@pytest.mark.parametrize("name", list(cases.STREAMS))
def test_take2d_warp_emulation_on_hub_streams(name):
    """The hub streams as rows of 128 (the stream repeated up to whole
    rows): long runs put one table row under many index rows."""
    idx, _val = cases.hub_stream(name)
    rows = -(-idx.numel() // 128)
    tiles = np.resize(idx.numpy(), rows * 128).reshape(rows, 128)
    nt = -(-cases.SIZE // 128) * 128
    tab2d = np.random.default_rng(22).integers(
        0, 1 << 30, (nt // 128, 128)).astype(np.int32)
    ref = _k_v1_jnp(tab2d, tiles)
    got, writes = _warp_take2d(tab2d, tiles, 3)
    assert (writes == 1).all()
    _same(torch.from_numpy(got), ref)
    _same(A.take2d(torch.from_numpy(tab2d), torch.from_numpy(tiles)), ref)

def _slab_take_axis0(tab2d, idx2, cols):
    """V2's kernel in numpy: each group's slab of `cols` columns, read at
    (row >> 7) * cols + column."""
    out = np.empty_like(idx2)
    for g in range(128 // cols):
        slab = np.ascontiguousarray(tab2d[:, g * cols:(g + 1) * cols])
        part = idx2[:, g * cols:(g + 1) * cols]
        out[:, g * cols:(g + 1) * cols] = slab.reshape(-1)[
            (part >> 7) * cols + np.arange(cols)]
    return out


@pytest.mark.parametrize("cols", A.SLAB_COLS)
@pytest.mark.parametrize("e,m", SHAPES)
def test_slab_take_axis0_emulation_matches_jnp(e, m, cols):
    d = _inputs(e, m, 14)
    ref = jnp.take_along_axis(jnp.asarray(d["tab2d"]),
                              jnp.asarray(d["idx2"]) // 128, axis=0)
    _same(torch.from_numpy(_slab_take_axis0(d["tab2d"], d["idx2"], cols)),
          ref)
    _same(A.take_axis0(_t(d["tab2d"]), _t(d["idx2"]), cols=cols), ref)


@pytest.mark.parametrize("name", list(cases.STREAMS))
def test_slab_take_axis0_emulation_on_hub_streams(name):
    """The hub streams as rows of 128 (the whole rows of each): every lane
    of a row reads its own column of one table row."""
    idx, _val = cases.hub_stream(name)
    rows = idx.numpy()[:idx.numel() // 128 * 128].reshape(-1, 128)
    nt = -(-cases.SIZE // 128) * 128
    tab2d = np.random.default_rng(15).integers(
        0, 1 << 30, (nt // 128, 128)).astype(np.int32)
    ref = jnp.take_along_axis(jnp.asarray(tab2d), jnp.asarray(rows) // 128,
                              axis=0)
    for cols in (32, 16):
        _same(torch.from_numpy(_slab_take_axis0(tab2d, rows, cols)), ref)
    _same(A.take_axis0(torch.from_numpy(tab2d), torch.from_numpy(rows)), ref)


# (nt, cols of the default plan): 32 columns up to 1816 rows, then the
# widest narrower slab that fits; nt not a multiple of cols x 128 included
SLAB_EDGES = [(128, 32), (1024, 32), (100_096, 32), (100_224, 32),
              (232_448, 32), (232_576, 16), (464_896, 16), (465_024, 8),
              (929_792, 8), (929_920, 4), (1_859_584, 4)]


@pytest.mark.parametrize("nt,cols", SLAB_EDGES)
def test_slab_plan_edges(nt, cols):
    plan = A.slab_plan(nt)
    assert plan.cols == cols and plan.groups * cols == 128
    assert plan.smem == 4 * (nt // 128) * cols <= A.SMEM_BLOCK
    if cols < A.SLAB_DEFAULT:  # the next wider slab does not fit
        assert not A.slab_fits(nt, 2 * cols)


def test_slab_plan_raises_past_slabs_of_4_columns():
    with pytest.raises(ValueError, match="1859584 entries"):
        A.slab_plan(1_859_584 + 128)
    with pytest.raises(ValueError, match="does not fit a block"):
        A.slab_plan(232_576, cols=32)
    for bad in (0, 1000):
        with pytest.raises(ValueError):
            A.slab_plan(bad)
    with pytest.raises(ValueError):
        A.slab_plan(1024, cols=64)


def test_take_and_slab_wrappers_take_their_options_on_the_cpu():
    """A slab width runs the plain version on the CPU; views at any offset
    are taken; a cycles buffer and a table past the plan are refused there
    as on the card; C1 takes any table."""
    d = _inputs(4096, 32, 16)
    table, idx = _t(d["table"]), _t(d["idx"])
    tab2d, idx2 = _t(d["tab2d"]), _t(d["idx2"])
    ref = jnp.asarray(d["table"])[jnp.asarray(d["idx"])]
    _same(A.take(table, idx[3:4001]), ref[3:4001])
    ref2 = jnp.take_along_axis(jnp.asarray(d["tab2d"]),
                               jnp.asarray(d["idx2"]) // 128, axis=0)
    for cols in (None, 32, 16, 8, 4):
        _same(A.take_axis0(tab2d, idx2, cols=cols), ref2)
    flat = _t(d["idx2"]).reshape(-1)
    view = torch.cat([flat[:1], flat])[1:].view(-1, 128)
    _same(A.take_axis0(tab2d, view), ref2)
    with pytest.raises(ValueError, match="card"):
        A.take_axis0(tab2d, idx2, cycles=torch.zeros(3, dtype=torch.int64))
    big = torch.zeros(332_257, dtype=torch.int32)
    assert torch.equal(A.take(big, idx), torch.zeros_like(idx))
    wide = torch.zeros((1_859_584 // 128 + 1, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="slabs of 4 columns hold at most"):
        A.take_axis0(wide, idx2)


def test_take2d_takes_its_options_on_the_cpu():
    """A cycles buffer is refused on the CPU, as for the other kernels
    with spans; ragged M and an unaligned table run the plain version."""
    d = _inputs(12345, 97, 17)
    tab2d, idx2 = _t(d["tab2d"]), _t(d["idx2"])
    with pytest.raises(ValueError, match="card"):
        A.take2d(tab2d, idx2, cycles=torch.zeros(3, dtype=torch.int64))
    flat = torch.cat([tab2d.reshape(-1)[:1], tab2d.reshape(-1)])
    shifted = flat[1:].view(-1, 128)
    assert shifted.data_ptr() % 16
    _same(A.take2d(shifted, idx2[:5]), A.take2d_plain(tab2d, idx2[:5]))
    rows = d["idx2"][:, :1] // 128
    _same(A.take2d(tab2d, idx2), d["tab2d"][rows, d["idx2"] % 128])
