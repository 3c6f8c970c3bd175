"""The program's own spans and counters (`rlap_tpu_torch/utils/tracing.py`),
read from a stretch of the run profiled for them.

The program keeps its spans and counters only while a profiler records.
The harness's traced stretch ends in the layers called alone, which run
`spmm` under the profiler too, and its trace is gone when the metrics are
read; so `read(ctx)` profiles a stretch of its own, once per run, after
the harness's: `profile_units` more units of the cell, with the program's
counters cleared just before them and read just after. A run without
`--trace 1`, or a program that keeps no counters, gives None, and every
metric that reads it then reads None.

In that stretch's Chrome trace, `SpanTrace`:

- attributes each device event (kernel, memcpy, memset) to the program
  spans open at the host time of its launch: the trace's
  `args.correlation` links it to the `cuda_runtime` (or `cuda_driver`)
  event that launched it. A device event keeps its whole interval, also
  where it ends after the span that launched it closed;
- takes spans from any thread (the autograd engine launches a backward's
  kernels from its own thread while `loss.backward()` waits inside
  `trainer.backward`);
- never counts a `gpu_user_annotation` event as device work: it is the
  profiler's copy of a span on the device's timeline.

A program span is a `user_annotation` event that is neither the
benchmark's own (`perfbench.`) nor torch's (a name with `#`, such as
`Optimizer.step#Adam.step`).
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import torch

from perfbench.harness import _sync
from perfbench.tracefile import DEVICE_CATEGORIES, union

LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
STRETCH = "perfbench.spans"


class SpanTrace:
    def __init__(self, events: List[dict]):
        self.spans: List[Tuple[float, float, str, int]] = []
        self.stretch: Optional[Tuple[float, float]] = None
        launch: Dict[object, float] = {}
        found = []
        for e in events:
            if e.get("ph") != "X":
                continue
            a = float(e["ts"])
            b = a + float(e.get("dur", 0.0))
            cat, args = e.get("cat"), e.get("args") or {}
            if cat == "user_annotation":
                if e["name"] == STRETCH:
                    self.stretch = (a, b)
                elif not e["name"].startswith("perfbench.") \
                        and "#" not in e["name"]:
                    self.spans.append((a, b, e["name"], e.get("tid", 0)))
            elif cat in DEVICE_CATEGORIES:
                found.append((a, b, e["name"], args.get("correlation")))
            elif cat in LAUNCH_CATEGORIES and "correlation" in args:
                c = args["correlation"]
                launch[c] = min(a, launch.get(c, a))
        # (start, end, name, host time of the launch or None)
        self.device = [(a, b, name, launch.get(c)) for a, b, name, c in found]
        # in the order they start, a parent before a child that starts
        # with it
        self.spans.sort(key=lambda s: (s[0], -s[1]))

    @classmethod
    def load(cls, path: str) -> "SpanTrace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def named(self, name: str) -> List[Tuple[float, float]]:
        return [(a, b) for a, b, n, _ in self.spans if n == name]

    def launched_in(self, name: str) -> List[Tuple[float, float, str]]:
        """The device events launched while a span named `name` was open
        (on any thread), with their whole intervals."""
        spans = self.named(name)
        starts = [a for a, _ in spans]
        out = []
        for a, b, ev, t in self.device:
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append((a, b, ev))
        return out

    def busy_launched_in_us(self, name: str) -> float:
        """The union of the device intervals launched inside `name`."""
        return sum(b - a for a, b in union(
            [(a, b) for a, b, _ in self.launched_in(name)]))

    def busy_us(self, lo: float, hi: float) -> float:
        return sum(b - a for a, b in union(
            [(max(a, lo), min(b, hi)) for a, b, _, _ in self.device
             if min(b, hi) > max(a, lo)]))

    def idle_in_us(self, name: str) -> float:
        """Over the spans named `name`: their length less the device's
        busy time inside them, whatever launched it."""
        return sum(b - a - self.busy_us(a, b) for a, b in self.named(name))

    def idle_by_span(self, lo: float, hi: float, k: int = 12) -> list:
        """[[program span, seconds], ...]: the device's idle time inside
        [lo, hi], each gap put under the innermost program span open at
        its middle (on any thread), summed by name, most first."""
        busy = union([(max(a, lo), min(b, hi)) for a, b, _, _ in self.device
                      if min(b, hi) > max(a, lo)])
        gaps, t = [], lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        by: Dict[str, float] = {}
        for (a, b), name in zip(gaps, self._innermost(
                [0.5 * (a + b) for a, b in gaps])):
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in
                sorted(by.items(), key=lambda kv: kv[1], reverse=True)[:k]]

    def _innermost(self, times: List[float]) -> List[str]:
        """For each of the ascending `times`, the shortest program span
        open at it, on any thread (one sweep, a stack a thread)."""
        stacks: Dict[int, list] = {}
        names, j = [], 0
        for t in times:
            while j < len(self.spans) and self.spans[j][0] <= t:
                a, b, name, tid = self.spans[j]
                st = stacks.setdefault(tid, [])
                while st and st[-1][0] < a:
                    st.pop()
                st.append((b, a, name))
                j += 1
            best = None
            for st in stacks.values():
                while st and st[-1][0] < t:
                    st.pop()
                if st and (best is None or
                           st[-1][0] - st[-1][1] < best[0] - best[1]):
                    best = st[-1]
            names.append(best[2] if best else "(no program span)")
        return names


def program_tracing():
    """The program's tracing module where it keeps counters, else None
    (a program from before its spans and counters)."""
    from rlap_tpu_torch.utils import tracing

    return tracing if hasattr(tracing, "counters") else None


def read(ctx) -> Optional[SimpleNamespace]:
    """The program's spans and counters over a stretch of `profile_units`
    units profiled for them (once a run; kept on `ctx`), or None.
    Returns `units`, `counters` ({name: float}) and `trace` (a
    `SpanTrace`); prints the device's idle time in the stretch by
    innermost program span to stderr."""
    if hasattr(ctx, "program_spans"):
        return ctx.program_spans
    ctx.program_spans = None
    tracing = program_tracing()
    if not ctx.trace or tracing is None or ctx.trainer is None:
        return None
    acts = [torch.profiler.ProfilerActivity.CPU]
    if ctx.dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    units = ctx.cell.traffic["profile_units"]
    with tempfile.TemporaryDirectory() as tmp:
        _sync(ctx.dev)
        tracing.counters()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(STRETCH):
                for _ in range(units):
                    ctx.unit()
                _sync(ctx.dev)
        counters = tracing.counters()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        tr = SpanTrace.load(path)
    lo, hi = tr.stretch
    print(f"program spans: {units} units, {len(tr.spans)} spans, "
          f"{len(tr.device)} device events; counters "
          f"{json.dumps(counters)}", file=sys.stderr)
    print("device idle (s) by innermost program span: "
          + json.dumps(tr.idle_by_span(lo, hi)), file=sys.stderr)
    ctx.program_spans = SimpleNamespace(units=units, counters=counters,
                                        trace=tr)
    return ctx.program_spans
