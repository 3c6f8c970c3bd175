"""The program's spans and counters, and reading them back from a trace
(counterpart of `rlap_tpu/utils/tracing.py`).

The program records only while a `torch.profiler` profile records, as
the profiler's own state says (`recording()`). With no profiler, a span
or a counter costs that one check, allocates nothing and launches no
work on the card; there is no environment variable or flag.

* `annotate(name)`: the program's span. While a profiler records it is a
  `torch.profiler.record_function` range, on the same clock as the host
  ops and the card's kernels, memcpys and memsets of the exported Chrome
  trace; otherwise one shared no-op context manager. Under Nsight
  Systems, `torch.autograd.profiler.emit_nvtx()` turns the same ranges
  into NVTX ranges.
* `count(name, n)`: the program's counter. While a profiler records it
  adds `n`, a host int or a 0-dimensional tensor, to the counter `name`.
  A tensor is summed where it lives and read once, by `counters()`, so
  counting adds no read-back. A call site whose count costs device work
  computes it only when `recording()`.
* `counters()`: every counter as `{name: float}`; clears them.
* `trace(log_dir)`: a context manager around `torch.profiler.profile`
  that records the host's activity, and the card's whenever CUDA is
  initialised; on exit it writes a Chrome trace to `<log_dir>/trace.json`.
* `device_time(path, span)`: what the card did inside one span of a
  trace: busy time, idle share and the ops that took most of it.
* `traced(label, body)`: `body()` run once under `trace` in a span of its
  own, read back with `device_time`.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Sequence, Union

import torch

_OFF = contextlib.nullcontext()
counters_: Dict[str, Union[int, torch.Tensor]] = {}


def recording() -> bool:
    """Whether a profiler records, so that spans and counters are kept."""
    return torch.autograd._profiler_enabled()


def annotate(name: str):
    """`with annotate("rlap.round"): ...`: a span of the trace while a
    profiler records, a shared no-op otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: Union[int, torch.Tensor]) -> None:
    """Add `n` to the counter `name` while a profiler records."""
    if torch.autograd._profiler_enabled():
        counters_[name] = counters_.get(name, 0) + n


def counters() -> Dict[str, float]:
    """The counters kept since the last call, read to the host; clears
    them."""
    out = {name: float(v) for name, v in counters_.items()}
    counters_.clear()
    return out


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


def traced(label: str, body: Callable, phases: Sequence[str] = ()) -> dict:
    """Run `body()` once under `trace`, in a span named `label` that ends
    with a synchronisation of the card (where CUDA is initialised), and
    read the card's work in that span from the trace with `device_time`,
    and in each span of `phases` that `body` annotates (work queued in
    one of those may run into the next). CUPTI starts on the first
    profiled region, so on the card a small one runs first. Returns
    `device_time`'s result for `label` with `wall_ms` (the host's clock
    around the span, from a synchronised card) and `phases`."""
    on_card = torch.cuda.is_initialized()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    with tempfile.TemporaryDirectory() as tmp:
        if on_card:
            with trace(os.path.join(tmp, "warm-up")):
                torch.ones(1 << 20, device="cuda").sum()
                sync()
        with trace(tmp):
            sync()
            t0 = time.perf_counter()
            with annotate(label):
                body()
                sync()
            wall = 1e3 * (time.perf_counter() - t0)
        path = os.path.join(tmp, "trace.json")
        res = device_time(path, label)
        res["phases"] = {p: device_time(path, p) for p in phases}
    res["wall_ms"] = wall
    return res
