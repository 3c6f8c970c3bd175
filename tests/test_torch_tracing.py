"""The port's tracing utilities, mirroring `tests/test_tracing.py`: TRACER
gating, Timer accounting with `sync` on a tensor and on a Graph,
`annotate`, and a profiler trace that holds the annotated span; and
`device_time`, which reads the card's busy time out of such a trace."""

import json

import pytest
import torch

from rlap_tpu_torch.data.synthetic import barabasi_albert
from rlap_tpu_torch.utils.tracing import (TRACER, Timer, annotate,
                                          device_time, trace, traced)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of a thread per core in each of them makes every
    small op wait on threads that are not scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tracer_gated(capsys, monkeypatch):
    monkeypatch.delenv("RLAP_TPU_TRACE", raising=False)
    TRACER("hidden %d", 1)
    assert capsys.readouterr().err == ""
    monkeypatch.setenv("RLAP_TPU_TRACE", "1")
    TRACER("shown %d", 2)
    TRACER("plain")
    err = capsys.readouterr().err
    assert "shown 2" in err and "plain" in err


def test_timer_and_annotation(capsys):
    t = Timer()
    g = barabasi_albert(50, 2, seed=0, device="cpu")
    with t("phase_a"):
        x = torch.ones(128) * 2
    with t("phase_a", sync=x):
        x = x + 1
    with t("phase_b", sync=(x, g)):
        _ = g.senders.sum()
    with t("phase_b", sync=g):
        pass
    with annotate("span"):
        _ = x.sum()
    assert t.counts == {"phase_a": 2, "phase_b": 2}
    assert t.totals["phase_a"] > 0
    totals = t.report()
    assert totals == t.totals
    err = capsys.readouterr().err
    assert "phase_a" in err and "2x" in err


def test_profiler_trace_holds_the_span(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d) as out:
        with annotate("square_sum"):
            _ = (torch.arange(1024.0) ** 2).sum()
    assert out == d
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = [e.get("name") for e in events["traceEvents"]]
    assert "square_sum" in names
    # on the host there is no card: the span holds no device work
    res = device_time(str(tmp_path / "trace" / "trace.json"), "square_sum")
    assert res["kernels"] == 0 and res["device_busy_ms"] == 0.0
    assert res["device_idle_share"] == 1.0 and res["span_ms"] > 0


def _write_trace(path, events):
    path.write_text(json.dumps({"traceEvents": events}))


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0}


def test_device_time_takes_the_union_inside_the_span(tmp_path):
    path = tmp_path / "trace.json"
    _write_trace(path, [
        _ev("user_annotation", "step", 1000.0, 1000.0),
        _ev("user_annotation", "other", 0.0, 5000.0),
        _ev("cpu_op", "aten::mm", 1000.0, 900.0),      # host: not counted
        _ev("kernel", "gemm", 1100.0, 200.0),          # 1100-1300
        _ev("kernel", "gemm", 1200.0, 200.0),          # overlaps: 1300-1400
        _ev("gpu_memcpy", "Memcpy HtoD", 1500.0, 100.0),
        _ev("gpu_memset", "Memset", 1550.0, 10.0),     # inside the memcpy
        _ev("kernel", "infonce_fwd", 1850.0, 300.0),   # clipped to 1850-2000
        _ev("kernel", "late", 2500.0, 100.0),          # outside the span
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1500.0},
    ])
    res = device_time(str(path), "step", top=2)
    assert res["span_ms"] == pytest.approx(1.0)
    # 1100-1400, 1500-1600 and 1850-2000: 550 us
    assert res["device_busy_ms"] == pytest.approx(0.55)
    assert res["device_idle_share"] == pytest.approx(0.45)
    assert res["kernels"] == 3
    assert [op["name"] for op in res["ops"]] == [
        "gemm", "infonce_fwd", "Memcpy HtoD", "Memset"]
    assert res["ops"][0] == {"name": "gemm", "ms": pytest.approx(0.4),
                             "count": 2}
    assert res["top_device_ops"] == res["ops"][:2]


def test_device_time_needs_one_span(tmp_path):
    path = tmp_path / "trace.json"
    _write_trace(path, [_ev("user_annotation", "step", 0.0, 10.0),
                        _ev("user_annotation", "step", 20.0, 10.0)])
    with pytest.raises(ValueError):
        device_time(str(path), "step")
    with pytest.raises(ValueError):
        device_time(str(path), "missing")


def test_traced_reads_one_call_and_its_phases():
    """`traced` runs its body once in a span of its own and reads the span
    and each named phase back from the trace; on the host the card did
    nothing in them."""
    calls = []

    def body():
        calls.append(1)
        with annotate("inner"):
            torch.ones(256).sum()

    res = traced("outer", body, phases=("inner",))
    assert calls == [1]
    assert res["span_ms"] > 0 and res["wall_ms"] > 0
    assert res["device_busy_ms"] == 0 and res["kernels"] == 0
    assert set(res["phases"]) == {"inner"}
    assert 0 < res["phases"]["inner"]["span_ms"] <= res["span_ms"]
