"""`spmm_tiled_launches.train`: the program's counter `spmm.tiled` per
profiled training step, as `perfbench/spans.py` keeps it; None where the
program keeps no such counter, so a program from before it reads
nothing."""

import json
from types import SimpleNamespace

import pytest

from perfbench import harness, spans

from .conftest import ROOT

NAME = "spmm_tiled_launches.train"


def _metric():
    return harness.load_file(ROOT / "perfbench" / "metrics" / f"{NAME}.py")


def _ctx(counters, drive="train_epoch", units=50):
    return SimpleNamespace(drive=drive, program_spans=SimpleNamespace(
        units=units, counters=counters, trace=spans.SpanTrace([])))


@pytest.mark.parametrize("counters,expected", [
    ({"spmm.tiled": 32.0, "spmm.slots": 1e6}, 0.64),  # one build in 50
    ({"spmm.tiled": 0.0, "spmm.slots": 1e6}, 0.0),    # every row one tile
    ({"spmm.slots": 1e6}, None),                      # no such counter
])
def test_the_counter_per_profiled_step(counters, expected):
    got = _metric().read(_ctx(counters))
    assert got == (None if expected is None else pytest.approx(expected))


def test_none_outside_training_and_without_a_trace(monkeypatch):
    assert _metric().read(_ctx({"spmm.tiled": 3.0}, drive="views")) is None
    monkeypatch.setattr(spans, "program_tracing", lambda: None)
    ctx = SimpleNamespace(trace=True, trainer=object(), drive="train_epoch")
    assert _metric().read(ctx) is None


def test_declared_for_the_mvgrl_cell_alone():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in bench["per_layer"]}[NAME]
    assert m["workloads"] == ["mvgrl-pubmed.train"]
    assert m["moves"] == "train_step_ms" and m["unit"] == "count"
    assert m["layer"] == {x["name"]: x for x in bench["per_layer"]}[
        "ppr_roofline"]["layer"]
