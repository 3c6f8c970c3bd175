"""The yardstick's counts of FLOPs and bytes against shapes worked by
hand, and the shares built from them."""

import pytest

from perfbench.metrics.lib import counts, peaks

PEAK = {"flops_f32": 1e12, "bytes_per_s": 1e9}


def test_matmul_counts_each_operand_once():
    op = counts.matmul(2, 3, 4)
    assert op.flops == 2 * 2 * 3 * 4
    assert op.bytes == 4 * (2 * 3 + 3 * 4 + 2 * 4)


def test_linear_backward_skips_the_input_gradient_where_not_needed():
    assert [o.flops for o in counts.linear_bwd(5, 6, 7)] == [420, 420]
    assert len(counts.linear_bwd(5, 6, 7, input_grad=False)) == 1


def test_spmm_reads_rows_indices_and_weights_once():
    op = counts.spmm(n=10, e=30, h=8)
    assert op.flops == 2 * 30 * 8
    assert op.bytes == 4 * 2 * 10 * 8 + (8 + 8 + 4) * 30


def test_gcn_norm_with_and_without_loops():
    with_loops = counts.gcn_norm(n=10, e=30, loops=True)
    without = counts.gcn_norm(n=10, e=30, loops=False)
    # reads 30 edges; writes 10 degrees, 40 (or 30) weights, 10 loop edges
    assert with_loops.bytes == 20 * 30 + 4 * (10 + 40) + 20 * 10
    assert without.bytes == 20 * 30 + 4 * (10 + 30)
    assert with_loops.flops == 3 * 40 + 10


def test_infonce_is_ten_n_squared_f_a_branch():
    ops = counts.infonce(n=100, f=8)
    assert [o.name for o in ops] == ["infonce_fwd", "infonce_bwd_da",
                                     "infonce_bwd_db"]
    assert sum(o.flops for o in ops) == 10 * 100 ** 2 * 8
    assert ops[0].bytes == 4 * (2 * 100 * 8 + 2 * 100)


def test_cca_loss_three_grams_and_their_gradients():
    ops = counts.cca_loss(n=50, d=4)
    assert len(ops) == 9
    assert sum(o.flops for o in ops) == 3 * 3 * 2 * 50 * 4 * 4


def test_least_seconds_takes_the_larger_bound_per_op():
    compute = counts.Op("a", 2e12, 1e6)     # 2 s of FLOPs, 1 ms of bytes
    memory = counts.Op("b", 1e9, 3e9)       # 1 ms of FLOPs, 3 s of bytes
    assert counts.least_seconds([compute, memory], PEAK) == pytest.approx(5)


def test_grace_step_counts_twenty_n_squared_f_in_its_loss(tiny_root):
    from perfbench import harness

    cell = harness.load_cell("grace-arxiv.train", tiny_root)
    rec = harness.load_file(cell.dir / "recipes" / "grace.py").Recipe(
        cell.config, "cpu")
    shapes = {"n": 400, "edges": [2000, 2100]}
    loss = counts.total_flops(rec.layer_ops("loss", shapes))
    infonce = 20 * 400 ** 2 * 16
    assert loss == pytest.approx(infonce + 2 * 8 * 400 * 16)
    step = counts.total_flops(rec.step_ops(shapes))
    # encoder of each view: norm, 2 x (matmul, spmm over e + n, act, their
    # backward; no input gradient at layer 0); the head, forward and back
    enc = 0
    for e in shapes["edges"]:
        enc += 3 * (e + 400) + 400
        for i in range(2):
            enc += 2 * 400 * 16 * 16 * (2 if i == 0 else 3)
            enc += 2 * 2 * (e + 400) * 16 + 2 * 400 * 16 + 2 * 400 * 16
    head = 2 * 6 * 2 * 400 * 16 * 16
    assert step == pytest.approx(enc + head + loss)


def test_peaks_know_the_h100_and_nothing_else():
    assert peaks.peaks("NVIDIA H100 80GB HBM3")["flops_f32"] == 495e12
    assert peaks.peaks("NVIDIA H100 80GB HBM3")["bytes_per_s"] == 3.35e12
    assert peaks.peaks("cpu") is None
