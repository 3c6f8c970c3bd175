"""Tracing and timing (counterpart of `rlap_tpu/utils/tracing.py`).

* `TRACER(fmt, *args)`: a printf to stderr, gated on the `RLAP_TPU_TRACE`
  environment variable.
* `trace(log_dir)`: a context manager around `torch.profiler.profile`
  that records the host's activity, and the card's whenever CUDA is
  initialised; on exit it writes a Chrome trace to `<log_dir>/trace.json`.
* `annotate(name)`: a named span in that trace
  (`torch.profiler.record_function`), and on the card an NVTX range too.
* `Timer`: an accumulating phase timer with a `report()` table; it
  synchronises the card before it reads the clock.
* `device_time(path, span)`: what the card did inside one span of a
  trace: busy time, idle share and the ops that took most of it.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Dict, List

import torch


def TRACER(fmt: str, *args) -> None:
    if os.environ.get("RLAP_TPU_TRACE"):
        print(fmt % args if args else fmt, file=sys.stderr, flush=True)


@contextlib.contextmanager
def trace(log_dir: str):
    """`with trace(d): step()`, then open `d/trace.json` in Perfetto or
    chrome://tracing, or read it with `device_time`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    with torch.profiler.record_function(name):
        if not torch.cuda.is_initialized():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def _cards(obj, found: set) -> set:
    """The CUDA devices of the tensors in `obj`: a tensor, anything with a
    `device` (a Graph), or a tuple or list of them."""
    if isinstance(obj, (tuple, list)):
        for o in obj:
            _cards(o, found)
    elif isinstance(obj, torch.Tensor) or hasattr(obj, "device"):
        if obj.device.type == "cuda":
            found.add(obj.device)
    return found


class Timer:
    """Accumulating phase timer: `with timer("views", sync=(g1, g2)): ...`.
    With `sync`, every card that holds one of its tensors is synchronised
    before the phase's clock stops, so the time covers the work queued."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        for dev in _cards(sync, set()):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, file=None) -> Dict[str, float]:
        """Print each phase's total, count and mean, most time first, to
        `file` (stderr by default); returns the totals in seconds."""
        file = sys.stderr if file is None else file
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            total = self.totals[name]
            cnt = self.counts[name]
            print(f"{name:40s} {total * 1e3:10.2f} ms total "
                  f"({cnt}x, {total / cnt * 1e3:.2f} ms each)",
                  file=file, flush=True)
        return dict(self.totals)


# the categories of torch's Chrome trace that are work on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_us(intervals: List[tuple]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def device_time(path: str, span: str, top: int = 5) -> dict:
    """The card's work inside the host span named `span` (an `annotate`
    of the traced code) of the Chrome trace at `path`. The host and the
    card's events share one clock in µs. Returns `span_ms`;
    `device_busy_ms`, the union of the kernel, memcpy and memset intervals
    clipped to the span (overlapping ones counted once);
    `device_idle_share` = 1 - busy / span; `kernels`, the count of kernel
    events in it; `ops`, every op name in it with its ms and count, most
    time first; and `top_device_ops`, the first `top` of them."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e.get("name") == span]
    if len(spans) != 1:
        raise ValueError(f"{path}: {len(spans)} host spans named {span!r}")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    clipped, by_name, kernels = [], {}, 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a = max(float(e["ts"]), lo)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), hi)
        if b <= a:
            continue
        clipped.append((a, b))
        kernels += e["cat"] == "kernel"
        ms, cnt = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + (b - a) / 1e3, cnt + 1)
    busy = _union_us(clipped) / 1e3
    span_ms = (hi - lo) / 1e3
    ops = [{"name": k, "ms": ms, "count": cnt} for k, (ms, cnt) in
           sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)]
    return {"span_ms": span_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / span_ms if span_ms > 0 else 1.0,
            "kernels": kernels, "top_device_ops": ops[:top], "ops": ops}
