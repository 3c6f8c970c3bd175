"""Reading a `torch.profiler` Chrome trace: the device's busy time inside
a host span, the device operations that took most of it, and the idle
gaps by what the host was doing.

The arithmetic is that of `rlap_tpu_torch/utils/tracing.py`
(`device_time`): busy is the union of the kernel, memcpy and memset
intervals clipped to the span, overlapping ones counted once; the host's
and the device's events share one clock in microseconds.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver")


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Trace:
    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        self.device: List[Tuple[float, float, str]] = []
        self.host: List[Tuple[float, float, str, int]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            a = float(e["ts"])
            b = a + float(e.get("dur", 0.0))
            cat = e.get("cat")
            if cat == "user_annotation":
                self.spans.setdefault(e["name"], []).append((a, b))
            elif cat in DEVICE_CATEGORIES:
                self.device.append((a, b, e["name"]))
            elif cat in HOST_CATEGORIES:
                self.host.append((a, b, e["name"], e.get("tid", 0)))

    def span(self, name: str) -> Tuple[float, float]:
        found = self.spans.get(name, [])
        if len(found) != 1:
            raise ValueError(f"{len(found)} host spans named {name!r}")
        return found[0]

    def _clipped(self, lo: float, hi: float):
        for a, b, name in self.device:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                yield a, b, name

    def busy_us(self, lo: float, hi: float) -> float:
        return sum(b - a for a, b in
                   union([(a, b) for a, b, _ in self._clipped(lo, hi)]))

    def top_ops(self, lo: float, hi: float, k: int = 10) -> list:
        """[[name, seconds], ...]: the device operations with the most
        time inside [lo, hi], most first."""
        by: Dict[str, float] = {}
        for a, b, name in self._clipped(lo, hi):
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in
                sorted(by.items(), key=lambda kv: kv[1], reverse=True)[:k]]

    def idle_gaps(self, lo: float, hi: float, k: int = 10) -> list:
        """[[host op, seconds], ...]: the device's idle time inside
        [lo, hi], each gap put under the innermost host operation that
        runs at its middle, summed by name, most first."""
        busy = union([(a, b) for a, b, _ in self._clipped(lo, hi)])
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
        """For each of the ascending `times`, the shortest host operation
        that runs at it, on any thread: one sweep over the host events in
        the order they start, with a stack of open events per thread."""
        hosts = sorted(self.host)
        stacks: Dict[int, list] = {}
        names, j = [], 0
        for t in times:
            while j < len(hosts) and hosts[j][0] <= t:
                a, b, name, tid = hosts[j]
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
            names.append(best[2] if best else "(no host op)")
        return names
