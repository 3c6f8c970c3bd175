"""Structured metrics logging in JSONL (counterpart of
`rlap_tpu/utils/logging.py`): one JSON object per event, with the same
keys as the JAX package's, so that each package reads the other's files.

`aggregate` and `results_table` read those files back into mean ± std
summaries and markdown or LaTeX tables.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional

import numpy as np


class MetricsLogger:
    """Append one record per `log` call to `path` (when given), echoing
    it to stderr (when `echo`). Every record holds `ts`, `run_id`,
    `event`, the logger's `context` and the call's fields."""

    def __init__(self, path: Optional[str] = None, run_id: str = "",
                 echo: bool = True, **context):
        self.path = Path(path) if path else None
        self.run_id = run_id or f"run-{int(time.time())}"
        self.context = context
        self.echo = echo
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, event: str, **fields) -> Dict[str, Any]:
        rec: Dict[str, Any] = {"ts": time.time(), "run_id": self.run_id,
                               "event": event, **self.context, **fields}
        line = json.dumps(rec, default=float)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line, file=sys.stderr, flush=True)
        return rec

    def metric(self, name: str, value, step: Optional[int] = None,
               **fields) -> Dict[str, Any]:
        return self.log("metric", name=name, value=float(value), step=step,
                        **fields)


def read_metrics(path: str, event: Optional[str] = None) -> Iterator[dict]:
    """The records of a JSONL file, optionally of one event. A truncated
    last line (a run killed while writing) is skipped."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if event is None or rec.get("event") == event:
                yield rec


def aggregate(paths, name: str) -> Dict[str, float]:
    """Mean, std and count of the metric `name` across files."""
    vals = [rec["value"] for p in paths for rec in read_metrics(p, "metric")
            if rec.get("name") == name]
    arr = np.asarray(vals, float)
    return {"mean": float(arr.mean()) if arr.size else float("nan"),
            "std": float(arr.std()) if arr.size else float("nan"),
            "n": int(arr.size)}


def results_table(paths, metric: str = "accuracy",
                  row_key: str = "augmentor", col_key: str = "dataset",
                  fmt: str = "markdown") -> str:
    """Pivot the `test_run` records of `paths` into a mean±std table,
    markdown or LaTeX. A cell of one sample prints no std."""
    cells: Dict[tuple, list] = {}
    for p in paths:
        for rec in read_metrics(p, "test_run"):
            if metric in rec:
                cells.setdefault((str(rec.get(row_key)),
                                  str(rec.get(col_key))), []).append(
                    float(rec[metric]))
    rows = sorted({k[0] for k in cells})
    cols = sorted({k[1] for k in cells})

    def cell(r, c):
        v = cells.get((r, c))
        if not v:
            return "-"
        a = np.asarray(v)
        if a.size == 1:
            return f"{a[0]:.4f} (n=1)"
        return f"{a.mean():.4f}±{a.std():.4f} (n={a.size})"

    if fmt == "latex":
        lines = ["\\begin{tabular}{l" + "c" * len(cols) + "}",
                 " & ".join([row_key] + cols) + " \\\\ \\hline"]
        for r in rows:
            lines.append(" & ".join([r] + [cell(r, c) for c in cols])
                         + " \\\\")
        lines.append("\\end{tabular}")
        return "\n".join(lines)
    header = "| " + " | ".join([row_key] + cols) + " |"
    sep = "|" + "|".join(["---"] * (len(cols) + 1)) + "|"
    body = ["| " + " | ".join([r] + [cell(r, c) for c in cols]) + " |"
            for r in rows]
    return "\n".join([header, sep] + body)
