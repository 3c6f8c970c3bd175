"""One run of one cell: inputs from the seed, set-up, a closed-loop window,
the traced stretch (with `--trace 1`), the check against the reference,
and the result line.

Everything that belongs to one configuration, traffic mix, metric or cell
sits in a file of its own under the benchmark's folder, found by the names
in `BENCHMARK.json`:

- `configs/<config>.json`: sizes and settings, with `recipe` naming
  `recipes/<recipe>.py`, the glue to the program and to the plain
  reference in `reference/`, and `graph` naming `graphs/<kind>.py`, which
  makes the inputs;
- `traffic/<traffic>.json`: what the closed loop drives (`drive`:
  `train_epoch` or `views`) and how many units are checked and traced;
- `metrics/<metric>.py`: `read(ctx)`, the metric's value or None where
  it finds nothing to read;
- `checks/<cell>.json`: the limit of each number compared.

The recipe owns its check. While the checked units run, its `recorders`
log what the reference needs (views, permutations, masks, each with the
key it came from); the harness moves that record to the host as it
stands and hands it, with the inputs the configuration made, to
`recipe.view_gap` (written as `view_diff`) and `recipe.reference_train`.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import random
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from perfbench import compare, graphgen, seeds, tracefile

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "rlap_tpu")


def forbidden_modules(names: Optional[Sequence[str]] = None) -> List[str]:
    """The top-level names among `names` (the loaded modules by default)
    that are exactly one of FORBIDDEN: `rlap_tpu_torch` is not
    `rlap_tpu`."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def load_file(path: Path):
    """A module of the benchmark's folder, loaded from its file (metric
    names hold dots, so they are not import paths)."""
    tag = "".join(c if c.isalnum() else "_" for c in str(path.relative_to(
        path.parents[1])))
    spec = importlib.util.spec_from_file_location(f"perfbench_file_{tag}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> SimpleNamespace:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    w = found[0]
    pb = root / "perfbench"
    return SimpleNamespace(
        name=name, chips=w["chips"], dir=pb,
        config=json.loads((pb / "configs" / f"{w['config']}.json")
                          .read_text()),
        traffic=json.loads((pb / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        limits=json.loads((pb / "checks" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def arm(recorders, log: Optional[list]) -> None:
    """Start (a list) or stop (None) the recording."""
    for rec in recorders:
        rec.log = log


def shapes(views) -> dict:
    """The nodes and each view's live edges, as the step got them."""
    return {"n": views[0].num_nodes,
            "edges": [int(g.edge_mask.sum()) for g in views]}


class Entry(NamedTuple):
    """One recorded call: what it made (`"view"`, `"perm"`, ...), the seed
    of the key it drew from, its output as plain tensors, and whether it
    returned a cached output instead of a fresh one."""
    what: str
    key: int
    value: object
    cached: bool


class Recorder:
    """Wraps a callable of the program, such as an augmentor `(g, key) ->
    view`. While `log` is a list, each call appends an `Entry`: `what`,
    the seed `key(*args)` reads (by default the last argument's, an
    augmentor's key), and the output as plain tensors. A call is marked
    cached where the callable that `fresh` wrapped did not run in it."""

    def __init__(self, fn: Optional[Callable] = None, what: str = "view",
                 key: Optional[Callable] = None):
        self.fn, self.what = fn, what
        self.key = key or (lambda *args: args[-1].initial_seed())
        self.log: Optional[list] = None
        self._watched = self._ran = False

    def fresh(self, inner: Callable) -> Callable:
        """`inner`, the callable that makes a fresh output behind a
        cache, wrapped so that the calls it runs in are told apart."""
        self._watched = True

        def call(*args):
            self._ran = True
            return inner(*args)

        return call

    def __call__(self, *args):
        if self.log is None:
            return self.fn(*args)
        seed = self.key(*args)
        self._ran = False
        out = self.fn(*args)
        self.log.append(Entry(self.what, seed, plain(out),
                              self._watched and not self._ran))
        return out


def graph_dict(g, device=None) -> dict:
    """A view as plain tensors (on `device`, or where it is)."""
    mv = (lambda t: t) if device is None else (lambda t: t.to(device))
    return {"senders": mv(g.senders), "receivers": mv(g.receivers),
            "weights": mv(g.weights), "x": mv(g.x), "num_nodes": g.num_nodes}


def plain(out):
    """A program's output as plain tensors: a graph as `graph_dict`, a
    tuple or list item by item."""
    if hasattr(out, "senders"):
        return graph_dict(out)
    if isinstance(out, (tuple, list)):
        return type(out)(plain(v) for v in out)
    return out


def moved(x, device):
    """Plain data with every tensor in it moved to `device`."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: moved(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(moved(v, device) for v in x)
    return x


def to_host(record: list) -> list:
    """The record with every tensor on the host, entry for entry."""
    return [e._replace(value=moved(e.value, "cpu")) for e in record]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Run:
    """The state of one run; metrics read it as `ctx`."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: torch.device, t0: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.dev, self.t0 = trace, device, t0
        self.drive = cell.traffic["drive"]
        self.device_kind = (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu")
        self.recipe = load_file(cell.dir / "recipes" /
                                f"{cell.config['recipe']}.py").Recipe(
            cell.config, device)
        self.latencies: List[float] = []
        self.losses: List[float] = []
        self.views_s: List[float] = []
        self.record: List[Entry] = []
        self.window_s = 0.0
        self.units = 0
        self.failed = 0
        self.profile = None   # SimpleNamespace of the traced stretch

    # -- set-up ---------------------------------------------------------
    def setup(self, faults: Sequence[Callable] = ()) -> None:
        """Inputs from the seed, the program's trainer, the warm-up; the
        seconds of each part since the last are kept in `setup_parts`."""
        parts, last = {}, [self.t0]

        def mark(name):
            _sync(self.dev)
            now = time.perf_counter()
            parts[name] = now - last[0]
            last[0] = now

        torch.zeros(1, device=self.dev)
        mark("interpreter_and_device")
        self.g = graphgen.make_graph(self.cell.config["graph"], self.seed,
                                     self.dev)
        mark("graph")
        self.weights0 = self.recipe.init_weights(
            seeds.generator(self.seed, "weights", self.dev))
        self.trainer = self.recipe.build(
            self.g, self.weights0, seeds.derive(self.seed, "trainer"))
        for fault in faults:
            fault(self)
        mark("trainer")
        if self.drive == "train_epoch":
            self._checked_steps(mark)
        else:
            self.unit()
            mark("first_unit")
        self.setup_s = last[0] - self.t0
        self.setup_parts = parts

    def _checked_steps(self, mark) -> None:
        """The window's own call drives the trainer through its first
        steps; their record, losses, the first gradient Adam takes and the
        change of the parameters are kept for the reference."""
        tr, steps = self.trainer, self.cell.traffic["check_steps"]
        names = dict(tr.model.named_parameters())
        p0 = {k: v.detach().clone() for k, v in names.items()}
        beta1 = tr.optimizer.param_groups[0]["betas"][0]
        log: list = []
        arm(self.recipe.recorders, log)
        for step in range(steps):
            self.losses.append(tr.train_epoch(self.g))
            mark(f"checked_step_{step}")
            if step == 0:
                self.prog_grad = {
                    k: tr.optimizer.state[p]["exp_avg"].detach().clone()
                    / (1 - beta1)
                    for k, p in names.items()
                    if "exp_avg" in tr.optimizer.state.get(p, {})}
        arm(self.recipe.recorders, None)
        self.prog_delta = {k: names[k].detach() - p0[k] for k in names}
        self.record = to_host(log)
        mark("record_to_host")

    def unit(self):
        if self.drive == "train_epoch":
            return self.trainer.train_epoch(self.g)
        out = self.trainer.views(self.g)
        _sync(self.dev)
        return out

    # -- the window -------------------------------------------------------
    def window(self) -> None:
        """Closed loop: the next unit starts when the last has synced.
        The views cell records a sample of its pairs, drawn from the seed,
        for the check, and moves the record to the host once the window
        has closed."""
        keep = set()
        log: list = []
        if self.drive == "views":
            pick = random.Random(seeds.derive(self.seed, "sample"))
            keep = set(pick.sample(range(self.cell.traffic["check_among"]),
                                   self.cell.traffic["check_units"]))
        if self.trace and self.drive == "train_epoch":
            self._time_views()
        start = time.perf_counter()
        end = start + self.seconds
        t = start
        i = 0
        while t < end:
            if i in keep:
                arm(self.recipe.recorders, log)
            a = time.perf_counter()
            out = self.unit()
            t = time.perf_counter()
            self.latencies.append(t - a)
            if self.drive == "train_epoch" and not math.isfinite(out):
                self.failed += 1
            if i in keep:
                arm(self.recipe.recorders, None)
            i += 1
        self.window_s = t - start
        self.units = i
        if self.drive == "views":
            self.record = to_host(log)
        if self.trace and self.drive == "train_epoch":
            del self.trainer.views

    def _time_views(self) -> None:
        """In the traced run: the views of each step timed between two
        syncs (the harness's own span)."""
        inner = self.trainer.views

        def views(g):
            _sync(self.dev)
            a = time.perf_counter()
            out = inner(g)
            _sync(self.dev)
            self.views_s.append(time.perf_counter() - a)
            return out

        self.trainer.views = views

    # -- the traced stretch -----------------------------------------------
    def traced(self) -> None:
        """A few units under `torch.profiler`, in one span, then each layer
        the recipe names called alone on the last unit's views, each in a
        span of its own."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with tempfile.TemporaryDirectory() as tmp:
            with torch.profiler.profile(activities=acts):   # CUPTI start-up
                torch.ones(1 << 20, device=self.dev).sum()
                _sync(self.dev)
            last: list = []
            inner = self.trainer.views

            def views(g):
                out = inner(g)
                last[:] = [out]
                return out

            self.trainer.views = views
            units = self.cell.traffic["profile_units"]
            with torch.profiler.profile(activities=acts) as prof:
                _sync(self.dev)
                with torch.profiler.record_function("perfbench.window"):
                    for _ in range(units):
                        self.unit()
                    _sync(self.dev)
                calls = (self.recipe.layer_calls(self.trainer, last[0])
                         if self.drive == "train_epoch" else {})
                for name, (prepare, call) in calls.items():
                    args = prepare()
                    _sync(self.dev)
                    with torch.profiler.record_function(
                            f"perfbench.layer.{name}"):
                        call(*args)
                        _sync(self.dev)
            del self.trainer.views
            t = time.perf_counter()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            size = os.path.getsize(path)
            tr = tracefile.Trace(path)
        t_read = time.perf_counter()
        lo, hi = tr.span("perfbench.window")
        layers = {}
        for name in calls:
            a, b = tr.span(f"perfbench.layer.{name}")
            layers[name] = tr.busy_us(a, b) / 1e6
        self.profile = SimpleNamespace(
            units=units, window_s=(hi - lo) / 1e6,
            busy_s=tr.busy_us(lo, hi) / 1e6, layer_busy_s=layers,
            shapes=shapes(last[0]),
            device_ops=tr.top_ops(lo, hi), idle_gaps=tr.idle_gaps(lo, hi))
        print(f"trace: {size} bytes, {len(tr.device)} device events; export "
              f"and parse {t_read - t:.2f} s, reading "
              f"{time.perf_counter() - t_read:.2f} s", file=sys.stderr)

    # -- the check --------------------------------------------------------
    def check(self) -> Dict[str, float]:
        """The program's state is freed first; the recipe's reference then
        judges the record and follows the checked steps."""
        rec = self.recipe
        self.trainer = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        out: Dict[str, float] = {}
        if self.record:
            out["view_diff"] = rec.view_gap(self.g, self.record)
        if self.drive == "train_epoch":
            losses, grad, params = rec.reference_train(self.weights0, self.g,
                                                       self.record)
            delta = {k: params[k] - self.weights0[k] for k in params}
            out.update(compare.train_gaps(
                self.losses, losses, self.prog_grad, grad,
                self.prog_delta, delta))
        return out


def device_info(dev: torch.device, count: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        root: Path = ROOT, device=None, t0: Optional[float] = None,
        faults: Sequence[Callable] = ()) -> dict:
    """One run; returns the result line as a dict, `checks` last.
    `device` and `faults` (callables given the run after its build) are
    for the tests."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = load_cell(cell_name, root)
    dev = torch.device(device or "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = Run(cell, seed, seconds, trace, dev, t0)
    r.setup(faults)
    r.window()
    if trace:
        r.traced()
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the benchmark forbids: "
                           f"{found}")
    info = device_info(dev, cell.chips)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_file(cell.dir / "metrics" / f"{m['name']}.py").read(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print("setup parts (s): " + json.dumps(r.setup_parts), file=sys.stderr)
    if r.latencies:
        q = sorted(r.latencies)
        print(f"window: {r.units} units in {r.window_s:.3f} s; latency min "
              f"{q[0]:.4f} median {q[len(q) // 2]:.4f} max {q[-1]:.4f} s",
              file=sys.stderr)
    result = {"correct": False, "attempted": r.units,
              "failed": r.failed, "metrics": metrics,
              "device": info}
    if trace and r.profile is not None:
        info["busy_s"] = r.profile.busy_s
        info["window_s"] = r.profile.window_s
        result["breakdown"] = {"device_ops": r.profile.device_ops,
                               "idle_gaps": r.profile.idle_gaps}
    gaps = r.check()
    checks = {}
    for name, limit in cell.limits.items():
        value = gaps.get(name, math.inf)
        # strict JSON has no inf or nan: a missing or broken number is
        # written as a string, and fails
        checks[name] = {"value": value if math.isfinite(value)
                        else str(value), "limit": limit}
    result["correct"] = bool(checks) and all(
        not isinstance(c["value"], str) and c["value"] <= c["limit"]
        for c in checks.values()) and result["failed"] == 0
    if forbidden_modules():
        raise RuntimeError(f"modules loaded that the benchmark forbids: "
                           f"{forbidden_modules()}")
    result["checks"] = checks
    return result
