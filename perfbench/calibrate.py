"""The readings that the limits in `checks/<cell>.json` are set from: for
each seed, in one process, the program's gaps to the reference (the lower
readings), and those of the control and of the planted faults (the upper
readings). The benchmark's own runs do not run this.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 ...
        [--faults 3] [--out chiprun_out/calib.jsonl]

- program: the cell's set-up path (checked steps for a training cell, a
  view pair for the views cell), judged as a run judges it;
- control: the reference put in the program's place one precision lower
  (every product in TF32; the rLap sampler in float32), judged against
  the reference;
- fault_half: the reference in the program's place with the loss over
  half the nodes (training cells);
- fault_edge: the program's first view with one edge moved;
- fault_still: a step that leaves the state unchanged reads 1 by the
  change's measure and needs no run.
Control and faults run on the first `--faults` seeds.
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
    from perfbench.reference import rlap as ref_rlap

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
            r.checked_views = [(s, harness.graph_dict(v)) for s, v in log]
        row = {"seed": seed, "program": r.check()}
        if i < faults:
            g = harness.graph_dict(r.g)
            rec = r.recipe
            n = g["num_nodes"]
            ctrl = {"view_diff": 0.0}
            for s, _ in r.checked_views:
                ref_e, ref_x = ref_rlap.view(g, s, rec.frac, rec.pf,
                                             rec.plumbing)
                lo_e, lo_x = ref_rlap.view(g, s, rec.frac, rec.pf,
                                           rec.plumbing, torch.float32)
                lower = {"senders": lo_e // (n + 1),
                         "receivers": lo_e % (n + 1),
                         "weights": torch.ones(lo_e.shape[0], device=dev),
                         "x": lo_x, "num_nodes": n}
                ctrl["view_diff"] += compare.view_diff(lower, ref_e, ref_x)
            s, view = r.checked_views[0]
            ref_e, ref_x = ref_rlap.view(g, s, rec.frac, rec.pf, rec.plumbing)
            moved = harness.graph_dict_to(view, dev)
            k = int((moved["senders"] < n).sum()) // 2
            moved["receivers"] = moved["receivers"].clone()
            moved["receivers"][k] = (moved["receivers"][k] + 1) % n
            row["fault_edge"] = {"view_diff": compare.view_diff(
                moved, ref_e, ref_x)}
            if r.drive == "train_epoch":
                views = [harness.graph_dict_to(v, dev)
                         for _, v in r.checked_views]
                pairs = [(views[2 * j], views[2 * j + 1])
                         for j in range(len(views) // 2)]
                ref = rec.reference_train(r.weights0, pairs)
                refd = {k: ref[2][k] - r.weights0[k] for k in ref[2]}

                def judged(out):
                    d = {k: out[2][k] - r.weights0[k] for k in out[2]}
                    return compare.train_gaps(out[0], ref[0], out[1],
                                              ref[1], d, refd)

                ctrl.update(judged(rec.reference_train(r.weights0, pairs,
                                                       tf32=True)))
                row["fault_half"] = judged(rec.reference_train(
                    r.weights0, pairs, half=True))
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
