"""The port's tracing: spans and counters kept only while a profiler
records (none, no work and the same results without one), the trainers'
and the rLap rounds' spans, the diffusion views' build spans and cache
counters, `spmm`'s padding counter, a profiler trace
that holds an annotated span, and `device_time`, which reads the card's
busy time out of such a trace."""

import json

import pytest
import torch

from rlap_tpu_torch.augment.base import Compose
from rlap_tpu_torch.augment import diffusion as D
from rlap_tpu_torch.augment.cca_registry import make_cca_augmentor
from rlap_tpu_torch.augment.feature import FeatureMasking
from rlap_tpu_torch.augment.registry import make_augmentor_pair
from rlap_tpu_torch.augment.rlap import RLap
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.data.synthetic import synthetic_node_dataset
from rlap_tpu_torch.models.cca_ssg import CCASSGTrainer
from rlap_tpu_torch.models.grace import GraceTrainer
from rlap_tpu_torch.models.mvgrl import MVGRLTrainer
from rlap_tpu_torch.ops import rlap as R
from rlap_tpu_torch.ops.spmm import spmm
from rlap_tpu_torch.utils import tracing
from rlap_tpu_torch.utils.tracing import (annotate, device_time, trace,
                                          traced)

STEP = ["trainer.views", "trainer.forward", "trainer.loss",
        "trainer.backward", "trainer.optimizer", "trainer.loss_readback"]
STAGES = ["rlap.select", "rlap.merge", "rlap.sample", "rlap.writeback",
          "rlap.end_test"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of a thread per core in each of them makes every
    small op wait on threads that are not scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_counts_left():
    tracing.counters()
    yield
    tracing.counters()


def _graph(n=96, seed=3):
    g, _ = synthetic_node_dataset(n=n, feature_dim=8, seed=seed,
                                  device="cpu")
    return g


def _grace(seed=0):
    views = [Compose([RLap(0.2, device="cpu"), FeatureMasking(0.3)])
             for _ in range(2)]
    return GraceTrainer(*views, hidden_dim=8, num_layers=2, block_size=32,
                        seed=seed, device="cpu")


def _cca(seed=0):
    return CCASSGTrainer(make_cca_augmentor("rlap", 0.2, 0.2),
                         hidden_dim=8, out_dim=8, seed=seed, device="cpu")


def _mvgrl(seed=0):
    """MVGRL on the registry's rLap + PPR pair, cut to 32 nodes of 96."""
    pair = make_augmentor_pair("rLapPPRDiffusion", 0.2, 0.2, device="cpu")
    return MVGRLTrainer(*pair, augmentor_name="rLapPPRDiffusion",
                        hidden_dim=8, subsample=32, seed=seed, device="cpu")


def _spans(d):
    """The trace's spans in `d/trace.json` as (start, end, name), in the
    order they start (a parent before its first child)."""
    events = json.loads((d / "trace.json").read_text())["traceEvents"]
    return sorted((float(e["ts"]), -float(e["dur"]), e["name"])
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation")


def _inside(spans, lo, hi, names):
    return [(a, a - nd, n) for a, nd, n in spans
            if n in names and lo <= a and a - nd <= hi]


def test_without_a_profiler_a_span_is_the_shared_noop():
    assert not tracing.recording()
    first, second = annotate("rlap.round"), annotate("trainer.step")
    assert first is second
    assert not isinstance(first, torch.profiler.record_function)
    with first:
        pass


def test_without_a_profiler_a_count_keeps_nothing():
    tracing.count("a", 3)
    tracing.count("b", torch.tensor(2))
    assert tracing.counters_ == {}
    assert tracing.counters() == {}


def test_an_unprofiled_epoch_records_nothing(monkeypatch):
    """No profiler: the program opens no `record_function` or NVTX range
    on a GRACE step (torch's own optimizer keeps its range, under
    `torch.autograd.profiler`), and keeps no counter."""

    def refuse(*args, **kw):
        raise AssertionError("a span was recorded with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", refuse)
    loss = _grace().train_epoch(_graph())
    assert loss == loss
    assert tracing.counters() == {}


@pytest.mark.parametrize("make", [_grace, _cca, _mvgrl],
                         ids=["grace", "cca_ssg", "mvgrl"])
def test_a_profiled_step_nests_its_phases_in_order(tmp_path, make):
    tr, g = make(), _graph()
    tr.train_epoch(g)                   # the model is built outside
    with trace(str(tmp_path)):
        tr.train_epoch(g)
    spans = _spans(tmp_path)
    steps = [(a, a - nd) for a, nd, n in spans if n == "trainer.step"]
    assert len(steps) == 1
    lo, hi = steps[0]
    phases = _inside(spans, lo, hi, STEP)
    assert [n for _, _, n in phases] == STEP
    assert len([n for _, _, n in spans if n in STEP]) == len(STEP)
    for (_, end, _), (start, _, _) in zip(phases, phases[1:]):
        assert end <= start             # one after another, not nested
    views = phases[0]
    # MVGRL's second call takes its diffusion view from the cache
    eliminations = 0 if make is _mvgrl else 2
    assert len(_inside(spans, views[0], views[1],
                       ["rlap.eliminate"])) == eliminations


def test_a_diffusion_build_and_its_cache_hits_are_kept(tmp_path):
    """A fresh diffusion view is one `diffusion.build` inside the views,
    holding the rLap, the series and the top-k in turn; the series
    counts nnz(T) x 32; the next call counts a cache hit and builds
    nothing. MVGRL's subsample is a span of the views."""
    tr, g = _mvgrl(), _graph()
    tr.ensure_init(g)
    diffusion, made = tr.aug2.augmentors[0].inner, []
    rlap = diffusion.rlap
    diffusion.rlap = lambda g, key: made.append(rlap(g, key)) or made[-1]
    with trace(str(tmp_path / "fresh")):
        tr.train_epoch(g)
    fresh = tracing.counters()
    spans = _spans(tmp_path / "fresh")
    (lo, hi), = [(a, a - nd) for a, nd, n in spans if n == "trainer.views"]
    (b0, b1), = [(a, a - nd) for a, nd, n in spans
                 if n == "diffusion.build"]
    assert lo <= b0 and b1 <= hi
    parts = ["diffusion.rlap", "diffusion.ppr", "diffusion.topk"]
    assert [n for _, _, n in _inside(spans, b0, b1, parts)] == parts
    assert len(_inside(spans, lo, hi, ["mvgrl.subsample"])) == 1
    assert fresh["diffusion.builds"] == 1
    assert "diffusion.cache_hits" not in fresh
    t = D._sym_norm_sparse(made[0], add_self_loop=False)
    assert fresh["diffusion.spmm_edges"] == 32 * t.edge_capacity > 0
    with trace(str(tmp_path / "cached")):
        tr.train_epoch(g)
    cached = tracing.counters()
    assert cached["diffusion.cache_hits"] == 1
    assert "diffusion.builds" not in cached
    assert not [n for _, _, n in _spans(tmp_path / "cached")
                if n.startswith("diffusion.")]


def test_each_round_is_a_span_with_its_stages(tmp_path):
    g = _graph(n=128)
    with trace(str(tmp_path)):
        _, removed, rounds = R.eliminate(g, rng.key(5, device="cpu"), 40,
                                         o_n="asc")
    counts = tracing.counters()
    assert removed == 40 and rounds > 1
    assert counts == {"rlap.views": 1.0, "rlap.rounds": float(rounds)}
    spans = _spans(tmp_path)
    [(lo, hi, _)] = _inside(spans, -1e300, 1e300, ["rlap.eliminate"])
    inner = [n for _, _, n in _inside(spans, lo, hi, ["rlap.entry",
                                                      "rlap.round",
                                                      "rlap.exit"])]
    assert inner == ["rlap.entry"] + ["rlap.round"] * rounds + ["rlap.exit"]
    for a, b, _ in _inside(spans, lo, hi, ["rlap.round"]):
        assert [n for _, _, n in _inside(spans, a, b, STAGES)] == STAGES


def test_a_pair_is_two_views_that_share_the_entry(tmp_path):
    g = _graph(n=128)
    with trace(str(tmp_path)):
        (_, _, r1), (_, _, r2) = R.eliminate_pair(
            g, rng.key(7, device="cpu"), 40)
    assert tracing.counters() == {"rlap.views": 2.0,
                                  "rlap.rounds": float(r1 + r2)}
    names = [n for _, _, n in _spans(tmp_path)]
    assert names.count("rlap.eliminate") == 2
    assert names.count("rlap.entry") == 1
    assert names.count("rlap.round") == r1 + r2


def test_spmm_counts_the_padding_it_gathers_once_at_export():
    g = G.with_capacity(_graph(n=64), 0)
    g = G.with_capacity(g, g.edge_capacity + 37)
    x = torch.randn(g.num_nodes, 4)
    padding = int((g.senders == g.num_nodes).sum())
    assert padding >= 37
    with torch.profiler.profile():
        spmm(g, x)
        spmm(g, x)
        kept = tracing.counters_["spmm.padding"]
    # summed where it lives, not read to the host until the export
    assert isinstance(kept, torch.Tensor) and kept.dim() == 0
    assert tracing.counters() == {"spmm.slots": 2.0 * g.edge_capacity,
                                  "spmm.padding": 2.0 * padding}
    spmm(g, x)                          # no profiler: nothing is counted
    assert tracing.counters() == {}


def test_a_profiled_run_gives_the_same_losses_and_views(tmp_path):
    g = _graph()
    plain, profiled = _grace(seed=4), _grace(seed=4)
    runs = []
    for tr, traced_ in ((plain, False), (profiled, True)):
        out = []
        for _ in range(2):
            if traced_:
                with trace(str(tmp_path)):
                    views = tr.views(g)
                    out.append((views, tr.train_step(*views)))
            else:
                views = tr.views(g)
                out.append((views, tr.train_step(*views)))
        runs.append(out)
    for (va, la), (vb, lb) in zip(*runs):
        assert la == lb
        for a, b in zip(va, vb):
            for field in ("senders", "receivers", "weights", "x"):
                assert torch.equal(getattr(a, field), getattr(b, field))
    assert tracing.counters()["spmm.slots"] > 0


def test_counters_sum_host_and_tensor_counts_and_clear():
    with torch.profiler.profile():
        assert tracing.recording()
        tracing.count("c", 2)
        tracing.count("c", torch.tensor(3))
        tracing.count("d", 1)
    assert not tracing.recording()
    assert tracing.counters() == {"c": 5.0, "d": 1.0}
    assert tracing.counters() == {}
    assert tracing.counters_ == {}


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
