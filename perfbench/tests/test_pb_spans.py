"""The program's spans and counters as the benchmark reads them
(`perfbench/spans.py` and the six metrics built on it): on a Chrome trace
written by hand, and in a tiny traced run on the CPU."""

import json
from types import SimpleNamespace

import pytest

from perfbench import harness, spans

from .conftest import ROOT

NEW = ["rlap_rounds_per_view", "rlap_round_ms", "rlap_readbacks_per_round",
       "spmm_padding_share.train", "backward_busy_ms.train",
       "views_idle_ms.train"]
DEVICE_ONLY = {"rlap_readbacks_per_round", "backward_busy_ms.train",
               "views_idle_ms.train"}


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=1, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, ts, 5.0, tid, corr)


DTOH = "Memcpy DtoH (Device -> Pinned)"
EVENTS = [
    _x("user_annotation", "perfbench.spans", 0.0, 10000.0),
    _x("user_annotation", "trainer.step", 100.0, 4900.0),
    _x("user_annotation", "trainer.views", 100.0, 900.0),
    _x("user_annotation", "rlap.eliminate", 150.0, 750.0),
    _x("user_annotation", "rlap.round", 200.0, 200.0),
    _x("user_annotation", "rlap.end_test", 240.0, 55.0),
    _x("user_annotation", "rlap.round", 500.0, 200.0),
    _x("user_annotation", "trainer.backward", 2000.0, 1000.0),
    _x("user_annotation", "Optimizer.step#Adam.step", 3000.0, 200.0),
    # round 1: a read-back and a kernel
    _launch(250.0, 1, name="cudaMemcpyAsync"),
    _x("gpu_memcpy", DTOH, 260.0, 10.0, tid=7, corr=1),
    _launch(300.0, 2),
    _x("kernel", "sort", 310.0, 40.0, tid=7, corr=2),
    # round 2: one read-back
    _launch(550.0, 3, name="cudaMemcpyAsync"),
    _x("gpu_memcpy", DTOH, 560.0, 5.0, tid=7, corr=3),
    # a read-back of the views outside any round
    _launch(800.0, 4, name="cudaMemcpyAsync"),
    _x("gpu_memcpy", DTOH, 810.0, 10.0, tid=7, corr=4),
    # the backward's kernels, launched from the autograd engine's thread;
    # the second ends after the span has closed
    _launch(2100.0, 5, tid=2),
    _x("kernel", "indexing_backward", 2200.0, 300.0, tid=7, corr=5),
    _launch(2900.0, 6, tid=2),
    _x("kernel", "indexing_backward", 2950.0, 550.0, tid=7, corr=6),
    # the profiler's copy of the span on the device's timeline: no work
    _x("gpu_user_annotation", "trainer.backward", 2000.0, 1500.0, tid=7),
    # launched outside every program span
    _launch(6000.0, 7),
    _x("kernel", "late", 6000.0, 100.0, tid=7, corr=7),
    {"ph": "s", "cat": "ac2g", "name": "launch", "ts": 2100.0, "id": 5},
]


def _ctx(events, counters, drive="train_epoch", units=1):
    return SimpleNamespace(drive=drive, program_spans=SimpleNamespace(
        units=units, counters=counters, trace=spans.SpanTrace(events)))


def _metric(name):
    return harness.load_file(ROOT / "perfbench" / "metrics" / f"{name}.py")


def test_device_events_go_to_the_spans_open_at_their_launch():
    tr = spans.SpanTrace(EVENTS)
    assert tr.stretch == (0.0, 10000.0)
    names = {n for _, _, n, _ in tr.spans}
    assert "Optimizer.step#Adam.step" not in names
    assert "perfbench.spans" not in names
    assert len(tr.device) == 7          # not the gpu_user_annotation
    back = tr.launched_in("trainer.backward")
    assert [(a, b) for a, b, _ in back] == [(2200.0, 2500.0),
                                            (2950.0, 3500.0)]
    # whole intervals, the one past the span's end included
    assert tr.busy_launched_in_us("trainer.backward") == 850.0
    rounds = tr.launched_in("rlap.round")
    assert [e[2] for e in rounds] == [DTOH, "sort", DTOH]
    assert tr.launched_in("rlap.end_test") == [(260.0, 270.0, DTOH)]


def test_idle_inside_a_span_and_by_innermost_span():
    tr = spans.SpanTrace(EVENTS)
    # views 100-1000: busy 260-270, 310-350, 560-565, 810-820
    assert tr.idle_in_us("trainer.views") == pytest.approx(900.0 - 65.0)
    idle = dict(tr.idle_by_span(0.0, 10000.0, k=20))
    assert idle["rlap.end_test"] == pytest.approx(
        (310.0 - 270.0) / 1e6)          # the gap 270-310 has its middle in it
    assert idle["(no program span)"] > 0
    assert sum(idle.values()) == pytest.approx(
        (10000.0 - tr.busy_us(0.0, 10000.0)) / 1e6)


@pytest.mark.parametrize("name,expected", [
    ("rlap_rounds_per_view", 14.0),
    ("rlap_round_ms", 0.2),
    ("rlap_readbacks_per_round", 1.0),
    ("spmm_padding_share.train", 2.5),
    ("backward_busy_ms.train", 0.425),
    ("views_idle_ms.train", 0.4175),
])
def test_each_metric_on_a_written_trace(name, expected):
    counters = {"rlap.views": 2.0, "rlap.rounds": 28.0,
                "spmm.slots": 4000.0, "spmm.padding": 100.0}
    ctx = _ctx(EVENTS, counters, units=2)
    assert _metric(name).read(ctx) == pytest.approx(expected)


def test_without_device_events_the_device_metrics_read_none():
    host_only = [e for e in EVENTS if e["cat"] == "user_annotation"]
    ctx = _ctx(host_only, {"rlap.views": 1.0, "rlap.rounds": 3.0,
                           "spmm.slots": 10.0, "spmm.padding": 0.0})
    for name in NEW:
        value = _metric(name).read(ctx)
        if name in DEVICE_ONLY:
            assert value is None, name
        else:
            assert value is not None, name
    assert _metric("spmm_padding_share.train").read(ctx) == 0.0


def test_a_program_that_keeps_no_counters_reads_none(monkeypatch):
    monkeypatch.setattr(spans, "program_tracing", lambda: None)
    ctx = SimpleNamespace(trace=True, trainer=object(), drive="views")
    assert spans.read(ctx) is None
    for name in NEW:
        assert _metric(name).read(ctx) is None


def test_the_program_keeps_counters():
    assert spans.program_tracing() is not None


def test_the_six_metrics_are_declared_for_their_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["source"] == "device_trace"
        assert (ROOT / "perfbench" / "metrics" / f"{name}.py").exists()
        cells = (["grace-arxiv.views"] if name.startswith("rlap_")
                 else ["grace-arxiv.train", "cca-arxiv.train"])
        assert m["workloads"] == cells


@pytest.mark.parametrize("cell,present,absent", [
    ("grace-arxiv.train", ["spmm_padding_share.train", "views_ms.train"],
     ["backward_busy_ms.train", "views_idle_ms.train", "step_mfu",
      "idle_share.train"]),
    ("cca-arxiv.train", ["spmm_padding_share.train", "views_ms.train"],
     ["backward_busy_ms.train", "views_idle_ms.train", "idle_share.train"]),
    ("grace-arxiv.views", ["rlap_rounds_per_view", "rlap_round_ms"],
     ["rlap_readbacks_per_round", "idle_share.views", "views_busy_ms"]),
])
def test_a_tiny_traced_run_reads_the_counters_and_spans(tiny_root, cell,
                                                        present, absent):
    out = harness.run(cell, 2 ** 33 + 17, 1.0, True, root=tiny_root,
                      device="cpu")
    assert out["correct"] is True
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    metrics = out["metrics"]
    for name in present:
        assert metrics[name]["value"] > 0, name
    for name in absent:
        assert name not in metrics, name
    if cell == "grace-arxiv.views":
        # each view of the tiny graph takes a few rounds
        assert 1 <= metrics["rlap_rounds_per_view"]["value"] < 30
        assert metrics["rlap_rounds_per_view"]["unit"] == "count"
    else:
        assert 0 < metrics["spmm_padding_share.train"]["value"] < 100
