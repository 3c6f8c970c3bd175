"""The readings that the limits in `checks/<cell>.json` are set from: for
each seed, in one process, the program's gaps to the reference (the lower
readings), and those of the control and of the planted faults (the upper
readings). The benchmark's own runs do not run this.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 ...
        [--faults 3] [--out chiprun_out/calib.jsonl]

- program: the cell's set-up path (checked steps for a training cell, a
  view pair for the views cell), judged as a run judges it;
- control: the reference put in the program's place one precision lower
  (`recipe.view_gap(..., dt=torch.float32)`: the rLap sampler in
  float32; `recipe.reference_train(..., tf32=True)`: every product in
  TF32), judged against the reference;
- fault_half: the reference in the program's place with the loss over
  half the nodes (training cells);
- fault_edge: the program's first recorded view with one edge moved;
- fault_still: a step that leaves the state unchanged reads 1 by the
  change's measure and needs no run.
Control and faults run on the first `--faults` seeds. Every reading comes
from the recipe's own `view_gap` and `reference_train`, the functions a
run's check calls.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seeds, faults: int, dev):
    """One row of readings a seed (see the module's docstring)."""
    import torch

    from perfbench import compare, harness

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        r = harness.Run(cell, seed, 0.0, False, dev, time.perf_counter())
        r.setup()
        if r.drive == "views":
            log: list = []
            harness.arm(r.recipe.recorders, log)
            r.unit()
            harness.arm(r.recipe.recorders, None)
            r.record = harness.to_host(log)
        row = {"seed": seed, "program": r.check()}
        if i < faults:
            rec, g, record = r.recipe, r.g, r.record
            ctrl = {"view_diff": rec.view_gap(g, record, torch.float32)}
            first = next(e for e in record if e.what == "view")
            view = dict(first.value)
            n = view["num_nodes"]
            k = int((view["senders"] < n).sum()) // 2
            view["receivers"] = view["receivers"].clone()
            view["receivers"][k] = (view["receivers"][k] + 1) % n
            row["fault_edge"] = {"view_diff": rec.view_gap(
                g, [first._replace(value=view)])}
            if r.drive == "train_epoch":
                ref = rec.reference_train(r.weights0, g, record)
                refd = {k: ref[2][k] - r.weights0[k] for k in ref[2]}

                def judged(out):
                    d = {k: out[2][k] - r.weights0[k] for k in out[2]}
                    return compare.train_gaps(out[0], ref[0], out[1],
                                              ref[1], d, refd)

                ctrl.update(judged(rec.reference_train(r.weights0, g, record,
                                                       tf32=True)))
                row["fault_half"] = judged(rec.reference_train(
                    r.weights0, g, record, half=True))
                row["fault_still"] = {"change_gap": 1.0}
            row["control"] = ctrl
        row["seconds"] = time.perf_counter() - t
        row["device"] = harness.device_info(dev, 1)["kind"]
        rows.append(row)
        print(json.dumps(row), flush=True)
        del r
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def summary(rows) -> dict:
    """The largest program reading and the least control and fault
    readings of each number."""
    out = {}
    for kind in ("program", "control", "fault_half", "fault_edge"):
        agg = max if kind == "program" else min
        for row in rows:
            for k, v in row.get(kind, {}).items():
                key = f"{kind}.{k}"
                out[key] = agg(out.get(key, v), v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose BENCHMARK.json and perfbench/ "
                         "to read")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness

    cell = harness.load_cell(args.workload, Path(args.root))
    rows = readings(cell, args.seeds, args.faults, torch.device(args.device))
    summ = summary(rows)
    print(json.dumps({"summary": summ}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows + [{"summary": summ,
                                "workload": args.workload}]:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
