"""Probe the cost of random table access on the card.

    python -m rlap_tpu_torch.bench.probe_access [n] [E] [reps] [--device cpu]

Counterpart of `tools/probe_access.py` and `tools/probe_access2.py`
together. The rLap round is dominated by vertex-table access: gathers from
an n-entry table by ~2 |edges| indices and scatter-mins into one
(`rlap_tpu_torch/ops/rlap.py` `_select`). This probe times, at the table
size n and index count E of a graph (defaults: BA(100k, m=8)):

  A. torch gathers: `index_select` on random and on sorted indices, and
     `gather` on random ones;
  B. torch scatters: `index_add_` and `scatter_reduce_("amin")` on random
     and on sorted indices;
  D. `torch.sort` of E keys with two payloads;
  C1-C4, V1-V4. the eight hand-written kernels of
     `rlap_tpu_torch/ops/access.py`, and the previous designs of C2, C3,
     C4, V2 and V4 (`take_two_level_chunks`, `take_scalar_l2`,
     `scatter_min_atomic`, `take_axis0_l2`, `take_axis0_axis1_l2`), each
     held bit-equal against
     its plain version first, then timed beside that plain version and a
     yardstick: A1 for the lookups, `index_select` of the same 8192
     indices for C3, B2 for the scatter-mins, advanced indexing
     `tab2d[rows0[:, None], lanes]` for V1, `take_along_dim` for V2-V4,
     all on
     ready-made int64 indices; on the card also V1's load and select
     spans;
  C2/V4 by cluster. C2 and V4 at every cluster size of (2, 4, 8) whose
     shared memory holds the table, each held bit-equal first: ms,
     clusters launched, bytes staged and (on the card) cluster 0's staging
     and lookup spans in SM cycles, and the lookup's rate of reads;
  V2 by slab. V2 at slabs of 32 and 16 columns, the same way: ms, and on
     the card block 0's staging and lookup spans and the bytes staged;
  Read rates. C1, V1 and both designs of C2, V2 and V4 timed again on twice
     the indices (each set and the next, end to end): E over the added
     time is the rate of reads with the launch, the staging and the tail
     taken out, and 2 t(E) - t(2E) is that fixed part;
  C3 cycles. the staging and walk spans of `take_scalar` in SM cycles, on
     random indices and, where the table spans more than one block, on
     indices that all fall in block 0's slice (local reads) and all in the
     other blocks' (remote reads).

Nothing is caught: a kernel that fails to build, launch or match raises.
On the card the times are CUDA-event times over `reps` launches, each on
indices it has not seen, queued behind a matrix product so that the host's
launch cost is off the clock. With `--device cpu` the wrappers run their
plain versions and the times are host-clock times of those (`"timer":
"host clock"` in the result): they say nothing about the card.

The bound of each kernel is its bytes (each input read once, each output
written once) over the H100's 3.35 TB/s; none does arithmetic worth
counting. `take_scalar` is a latency probe: one thread walks its 8192
indices one after another, as the TPU probe's scalar loop does, so its
bytes bound is printed but is not what holds it back; the cycles of its
walk are (a parallel gather would be C1 again).
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.ops import access as A

HBM_BYTES = 3.35e12  # H100 SXM, NVIDIA's data sheet
TILE = A.TILE  # elements of the scalar probe, as in the tool
_BLOCKER = 4096  # side of the matrix product that holds the queue back


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn: Callable, args: Sequence[tuple]) -> float:
    """Mean ms of `fn(*a)` over `args[1:]`, after `fn(*args[0])` as warm-up.
    CUDA events on the card, the host clock on the CPU."""
    fn(*args[0])
    reps = len(args) - 1
    dev = args[0][0].device
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for a in args[1:]:
            fn(*a)
        return 1e3 * (time.perf_counter() - t0) / reps
    block = torch.zeros((_BLOCKER, _BLOCKER), device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    block @ block
    start.record()
    for a in args[1:]:
        fn(*a)
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def make_inputs(n: int, e: int, m: int, sets: int, device, seed: int) -> dict:
    """A table of n int32 entries (padded with zeros to NT, a multiple of
    128, and as [R, 128]), and `sets` fresh draws of E indices, E values
    and [M, 128] index tiles, all from `seed` on `device`."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(high, shape):
        return torch.randint(0, high, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    nt = -(-n // A.LANES) * A.LANES
    table = draw(1 << 30, (n,))
    tpad = torch.cat([table, torch.zeros(nt - n, dtype=torch.int32,
                                         device=dev)])
    return {"n": n, "nt": nt, "e": e, "m": m, "table": table, "tpad": tpad,
            "tab2d": tpad.view(nt // A.LANES, A.LANES),
            "idx": [draw(n, (e,)) for _ in range(sets)],
            "val": [draw(1 << 20, (e,)) for _ in range(sets)],
            "idx2": [draw(n, (m, A.LANES)) for _ in range(sets)]}


def _calls(inp: dict) -> Dict[str, tuple]:
    """name -> (kernel wrapper, plain version, argument tuples)."""
    tile = min(TILE, inp["e"])
    nt = inp["nt"]
    one_d = [(inp["table"], i) for i in inp["idx"]]
    two_level = [(inp["tab2d"], i) for i in inp["idx"]]
    tiles = [(inp["tab2d"], i) for i in inp["idx2"]]
    scalar = [(inp["table"], i[:tile]) for i in inp["idx"]]
    scatter = [(i, v, nt) for i, v in zip(inp["idx"], inp["val"])]
    return {
        "take": (A.take, A.take_plain, one_d),
        "take_two_level": (A.take_two_level, A.take_two_level_plain,
                           two_level),
        "take_two_level_chunks": (A.take_two_level_chunks,
                                  A.take_two_level_plain, two_level),
        "take_scalar": (A.take_scalar, A.take_plain, scalar),
        "scatter_min": (A.scatter_min, A.scatter_min_plain, scatter),
        "take2d": (A.take2d, A.take2d_plain, tiles),
        "take_axis0": (A.take_axis0, A.take_axis0_plain, tiles),
        "take_axis0_l2": (A.take_axis0_l2, A.take_axis0_plain, tiles),
        "take_axis1": (A.take_axis1, A.take_axis1_plain, tiles),
        "take_axis0_axis1": (A.take_axis0_axis1, A.take_axis0_axis1_plain,
                             tiles),
        "take_axis0_axis1_l2": (A.take_axis0_axis1_l2,
                                A.take_axis0_axis1_plain, tiles),
        "take_scalar_l2": (A.take_scalar_l2, A.take_plain, scalar),
        "scatter_min_atomic": (A.scatter_min_atomic, A.scatter_min_plain,
                               scatter),
    }


def hold(name: str, kern: Callable, plain: Callable, args: tuple,
         where: str = "") -> int:
    """Hold kernel `name`'s wrapper `kern` against its plain version on
    `args`: the same shape and dtype, bit-equal, and one launch counted
    for the call on the card (none on the CPU). Returns the max abs
    error: 0."""
    dev = args[0].device
    on_card = dev.type == "cuda"
    before = A.launch_counts[name]
    got, ref = kern(*args), plain(*args)
    if on_card:
        torch.cuda.synchronize(dev)
    launched = A.launch_counts[name] - before
    _require(launched == int(on_card),
             f"{name}: {launched} launches counted for one call on {dev}")
    _require(got.shape == ref.shape and got.dtype == ref.dtype,
             f"{name}: {got.shape} {got.dtype} against {ref.shape} "
             f"{ref.dtype}")
    err = int((got.long() - ref.long()).abs().max()) if got.numel() else 0
    _require(torch.equal(got, ref),
             f"{name}: differs from its plain version{where}, max abs err "
             f"{err}")
    return err


def check(inp: dict) -> Dict[str, int]:
    """Hold each kernel and previous variant against its plain version on
    the first draw of `inp` (`hold`). Returns the max abs error per
    kernel: 0."""
    where = f" at n={inp['n']} E={inp['e']} M={inp['m']}"
    return {name: hold(name, kern, plain, args[0], where)
            for name, (kern, plain, args) in _calls(inp).items()}


def rate_parts(ms: float, ms_twice: float) -> Tuple[float, float]:
    """From a call's ms on E elements and on 2E: (t(2E) - t(E), the ms
    that E more elements add, and 2 t(E) - t(2E), the part a launch costs
    whatever its size: launch, staging, tail)."""
    added = ms_twice - ms
    return added, ms - added


def bounds_ms(inp: dict) -> Dict[str, float]:
    """Bytes each kernel must move (indices and values read once, the part
    of the table it can touch read once, outputs written once; the
    scatter-min table written by the fill and by the reduction), in ms at
    the HBM rate."""
    n, nt, e, cells = inp["n"], inp["nt"], inp["e"], inp["m"] * A.LANES
    tile = min(TILE, e)
    nbytes = {
        "take": 8 * e + 4 * n,
        "take_two_level": 8 * e + 4 * nt,
        "take_scalar": 8 * tile + 4 * min(n, tile),
        "scatter_min": 8 * e + 8 * nt,
        "take2d": 8 * cells + 4 * nt,
        "take_axis0": 8 * cells + 4 * nt,
        "take_axis1": 8 * cells + 4 * A.LANES,
        "take_axis0_axis1": 8 * cells + 4 * nt,
    }
    for prev, kname in (("take_two_level_chunks", "take_two_level"),
                        ("take_scalar_l2", "take_scalar"),
                        ("scatter_min_atomic", "scatter_min"),
                        ("take_axis0_axis1_l2", "take_axis0_axis1"),
                        ("take_axis0_l2", "take_axis0")):
        nbytes[prev] = nbytes[kname]
    return {k: 1e3 * v / HBM_BYTES for k, v in nbytes.items()}


def _index_select(table, idx64) -> torch.Tensor:
    return torch.index_select(table, 0, idx64)


def merged_reds(idx: torch.Tensor) -> int:
    """How many atomics `scatter_min` issues on `idx`: one for each of the
    head and tail updates; of each whole quad, one for each run of equal
    neighbours that ends in slots 0-2; and of slot 3, one for each distinct
    index among a warp's 32 quads where two neighbouring quads end on the
    same index, else one a quad. The previous design issues one for every
    update."""
    e = idx.numel()
    head, quads = A.vector_split(idx.data_ptr(), e)
    body = idx[head:head + 4 * quads].view(quads, 4).to(torch.int64)
    ends = int((body[:, :3] != body[:, 1:]).sum())
    last, warp = body[:, 3], torch.arange(quads, device=idx.device) // 32
    repeats = torch.zeros(-(-quads // 32), dtype=torch.bool,
                          device=idx.device)
    repeats[warp[1:][(last[1:] == last[:-1]) & (warp[1:] == warp[:-1])]] = True
    merged = repeats[warp]
    slot3 = int(torch.unique(warp[merged] * (1 << 31) + last[merged]).numel())
    return ends + slot3 + int((~merged).sum()) + e - 4 * quads


def time_stream(table: torch.Tensor, gather_idx: torch.Tensor,
                scatter_idx: torch.Tensor, val: torch.Tensor,
                reps: int) -> dict:
    """`take` and both designs of `take_two_level` (the table padded to
    rows of 128) by `gather_idx`, `take2d` on its whole rows of 128, and
    both designs of `scatter_min` of `val` at
    `scatter_idx`, on given index streams, beside torch's `index_select`
    and `scatter_reduce_("amin")` on the same streams as int64; and both
    designs of `take_scalar` on the first `TILE` indices of `gather_idx`.
    Each is held bit-equal to its plain version first, and so are both
    designs of `take_axis0` and of `take_axis0_axis1`, and `take_axis1`,
    on the same rows (not timed).
    Each repetition works on its own copy of the streams, so that the
    indices come from device memory and not from L2."""
    n = table.shape[0]
    nt = -(-n // A.LANES) * A.LANES
    tab2d = torch.cat([table, table.new_zeros(nt - n)]).view(-1, A.LANES)
    sets = range(reps + 1)
    gathers = [gather_idx.clone() for _ in sets]
    scatters = [scatter_idx.clone() for _ in sets]
    vals = [val.clone() for _ in sets]
    tile = gather_idx[:TILE]
    ref = A.scatter_min_plain(scatter_idx, val, n)
    looked_up = A.take_plain(table, gather_idx)
    whole = gather_idx.numel() // A.LANES * A.LANES
    rows = gather_idx[:whole].view(-1, A.LANES)
    by_rows = A.take_axis0_axis1_plain(tab2d, rows)
    by_col = A.take_axis0_plain(tab2d, rows)
    by_first = A.take2d_plain(tab2d, rows)
    errs = {}
    for name, (got, want) in (
            ("take", (A.take(table, gather_idx), looked_up)),
            ("take2d", (A.take2d(tab2d, rows), by_first)),
            ("take_axis0", (A.take_axis0(tab2d, rows), by_col)),
            ("take_axis0_l2", (A.take_axis0_l2(tab2d, rows), by_col)),
            ("take_axis1", (A.take_axis1(tab2d, rows),
                            A.take_axis1_plain(tab2d, rows))),
            ("take_two_level", (A.take_two_level(tab2d, gather_idx),
                                looked_up)),
            ("take_two_level_chunks",
             (A.take_two_level_chunks(tab2d, gather_idx), looked_up)),
            ("take_axis0_axis1", (A.take_axis0_axis1(tab2d, rows), by_rows)),
            ("take_axis0_axis1_l2",
             (A.take_axis0_axis1_l2(tab2d, rows), by_rows)),
            ("take_scalar", (A.take_scalar(table, tile),
                             A.take_plain(table, tile))),
            ("take_scalar_l2", (A.take_scalar_l2(table, tile),
                                A.take_plain(table, tile))),
            ("scatter_min", (A.scatter_min(scatter_idx, val, n), ref)),
            ("scatter_min_atomic",
             (A.scatter_min_atomic(scatter_idx, val, n), ref))):
        errs[name] = int((got.long() - want.long()).abs().max())
        _require(torch.equal(got, want),
                 f"{name} differs from its plain version on the given "
                 f"stream, max abs err {errs[name]}")
    scatter_args = [(i, v, n) for i, v in zip(scatters, vals)]
    scalar_args = [(table, i[:TILE]) for i in gathers]
    row_args = [(tab2d, i[:whole].view(-1, A.LANES)) for i in gathers]
    return {
        "n": n, "e": gather_idx.shape[0], "rows": rows.shape[0],
        "take_ms": time_ms(A.take, [(table, i) for i in gathers]),
        "take_two_level_ms": time_ms(A.take_two_level,
                                     [(tab2d, i) for i in gathers]),
        "take_two_level_chunks_ms": time_ms(A.take_two_level_chunks,
                                            [(tab2d, i) for i in gathers]),
        "index_select_ms": time_ms(
            _index_select, [(table, i.to(torch.int64)) for i in gathers]),
        "take2d_ms": time_ms(A.take2d, row_args),
        "scatter_min_ms": time_ms(A.scatter_min, scatter_args),
        "scatter_min_atomic_ms": time_ms(A.scatter_min_atomic, scatter_args),
        "scatter_reduce_ms": time_ms(
            _torch_scatter_min,
            [(i.to(torch.int64), v, n) for i, v in zip(scatters, vals)]),
        "scatter_min_reds": merged_reds(scatter_idx),
        "take_scalar_ms": time_ms(A.take_scalar, scalar_args),
        "take_scalar_l2_ms": time_ms(A.take_scalar_l2, scalar_args),
        "max_abs_err": errs,
    }


def scalar_cycles(table: torch.Tensor, idx: torch.Tensor,
                  reps: int = 5) -> dict:
    """`take_scalar`'s staging and walk spans in SM cycles (the median of
    `reps` launches) and its local and remote reads, on the card."""
    cyc = torch.zeros(3, dtype=torch.int64, device=table.device)
    spans = []
    for _ in range(reps):
        A.take_scalar(table, idx, cycles=cyc)
        spans.append(cyc.tolist())
    stage, walk, remote = (sorted(c)[len(c) // 2] for c in zip(*spans))
    e = idx.numel()
    return {"stage_cycles": stage, "walk_cycles": walk,
            "cycles_per_element": walk / e, "remote_reads": remote,
            "local_reads": e - remote}


def _torch_scatter_min(idx64, val, size: int) -> torch.Tensor:
    out = torch.full((size,), A.FILL, dtype=torch.int32, device=val.device)
    return out.scatter_reduce_(0, idx64, val, "amin")


def _torch_sections(inp: dict, emit) -> Dict[str, float]:
    """Sections A, B and D: torch's own gathers, scatters and sort."""
    table, n = inp["table"], inp["n"]
    rnd = [i.to(torch.int64) for i in inp["idx"]]
    srt = [torch.sort(i).values for i in rnd]
    fval = [v.to(torch.float32) for v in inp["val"]]

    def add(i, v):
        return torch.zeros(n, dtype=torch.float32,
                           device=v.device).index_add_(0, i, v)

    def sort3(k, p1, p2):
        keys, order = torch.sort(k)
        return keys, p1[order], p2[order]

    rows = [
        ("A1 index_select, random idx", _index_select,
         [(table, i) for i in rnd]),
        ("A2 index_select, sorted idx", _index_select,
         [(table, i) for i in srt]),
        ("A3 gather, random idx",
         lambda t, i: torch.gather(t, 0, i), [(table, i) for i in rnd]),
        ("B1 index_add_, random idx", add, list(zip(rnd, fval))),
        ("B2 scatter_reduce_ amin, random idx", _torch_scatter_min,
         [(i, v, n) for i, v in zip(rnd, inp["val"])]),
        ("B3 index_add_, sorted idx", add, list(zip(srt, fval))),
        ("B4 scatter_reduce_ amin, sorted idx", _torch_scatter_min,
         [(i, v, n) for i, v in zip(srt, inp["val"])]),
        ("D1 sort E keys + 2 payloads", sort3,
         [(i, j, v) for i, j, v in zip(inp["idx"], rnd, fval)]),
    ]
    out = {}
    for name, fn, args in rows:
        out[name] = time_ms(fn, args)
        emit(f"{name:55s} {out[name]:9.4f} ms")
    return out


def _yardsticks(inp: dict, torch_ms: Dict[str, float]) -> Dict[str, float]:
    """One torch call for each kernel's function, on int64 indices made
    beforehand: V1 advanced indexing `tab2d[rows0[:, None], lanes]` (rows0
    the row of each index row's first index), V2-V4 `take_along_dim`."""
    tab2d, m = inp["tab2d"], inp["m"]
    rows = [(i // A.LANES).to(torch.int64) for i in inp["idx2"]]
    lanes = [(i % A.LANES).to(torch.int64) for i in inp["idx2"]]
    row0 = tab2d[0:1].expand(m, A.LANES)
    a1 = torch_ms["A1 index_select, random idx"]
    tile = min(TILE, inp["e"])
    scalar = time_ms(_index_select, [(inp["table"], i[:tile].to(torch.int64))
                                     for i in inp["idx"]])
    axis0 = time_ms(lambda t, r: torch.take_along_dim(t, r, 0),
                    [(tab2d, r) for r in rows])
    v4 = time_ms(lambda t, r, ln: torch.take_along_dim(
        torch.take_along_dim(t, r, 0), ln, 1),
        [(tab2d, r, ln) for r, ln in zip(rows, lanes)])
    return {
        "take": a1, "take_two_level": a1,
        "take_two_level_chunks": a1,
        "take_scalar": scalar, "take_scalar_l2": scalar,
        "take2d": time_ms(lambda t, r0, ln: t[r0, ln],
                          [(tab2d, r[:, :1].contiguous(), ln)
                           for r, ln in zip(rows, lanes)]),
        "scatter_min": torch_ms["B2 scatter_reduce_ amin, random idx"],
        "scatter_min_atomic": torch_ms["B2 scatter_reduce_ amin, random idx"],
        "take_axis0": axis0, "take_axis0_l2": axis0,
        "take_axis1": time_ms(lambda t, ln: torch.take_along_dim(t, ln, 1),
                              [(row0, ln) for ln in lanes]),
        "take_axis0_axis1": v4, "take_axis0_axis1_l2": v4,
    }


def run(n: int = 100_000, e: int = 1_600_000, reps: int = 10, device=None,
        seed: int = 0, emit: Callable[[str], None] = print) -> dict:
    """Run every section at table size `n` and `e` indices (the 2-D kernels
    on `e // 128` tiles of 128) on `device` (the card by default). Returns
    the result, which `main` prints as one JSON line."""
    dev = resolve_device(device)
    _require(n > 0 and e >= A.LANES and reps > 0,
             f"need n > 0, E >= {A.LANES} and reps > 0, got {n} {e} {reps}")
    on_card = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    emit(f"device: {name} n={n} E={e} reps={reps}")
    inp = make_inputs(n, e, e // A.LANES, reps + 1, dev, seed)
    torch_ms = _torch_sections(inp, emit)

    errs = check(inp)
    emit(f"C1-C4, V1-V4 and their other designs bit-equal to their plain "
         f"versions at n={n} E={e} M={inp['m']}")
    before = dict(A.launch_counts)
    yard = _yardsticks(inp, torch_ms)
    bound = bounds_ms(inp)
    rows = {}
    calls = _calls(inp)
    for kname, (kern, plain, args) in calls.items():
        ms = time_ms(kern, args)
        elems = e if "scatter" in kname else args[0][-1].numel()
        rows[kname] = {
            "ms": ms, "plain_ms": time_ms(plain, args),
            "yardstick_ms": yard[kname], "bound_ms": bound[kname],
            "bound_by": "bytes", "elements": elems,
            "elements_per_s": elems / (1e-3 * ms), "max_abs_err": errs[kname],
        }
        emit(f"{kname:20s} {ms:9.4f} ms  plain {rows[kname]['plain_ms']:9.4f}"
             f"  yardstick {yard[kname]:9.4f}  bound {bound[kname]:.5f} ms")
    for kname in ("take_scalar", "take_scalar_l2"):
        sc = rows[kname]
        sc["ms_scaled_to_e"] = sc["ms"] * e / sc["elements"]
        emit(f"   {kname} scaled to E: {sc['ms_scaled_to_e']:.2f} ms")
    for kname in ("scatter_min", "scatter_min_atomic"):
        rows[kname]["reds"] = e if kname == "scatter_min_atomic" \
            else merged_reds(inp["idx"][0])
    # the slab table's default plan, and on the card its spans and V1's
    rows["take_axis0"]["plan"] = A.slab_plan(inp["nt"])._asdict()
    if on_card:
        rows["take_axis0"].update(slab_spans(calls["take_axis0"][2][0]))
        rows["take2d"].update(take2d_spans(calls["take2d"][2][0]))
        emit(f"   take2d: load {rows['take2d']['load_cycles']} select "
             f"{rows['take2d']['select_cycles']} cycles (warp 0 of block "
             f"0), {rows['take2d']['blocks']} blocks")
        emit(f"   take_axis0 default plan {rows['take_axis0']['plan']}: "
             f"stage {rows['take_axis0']['stage_cycles']} lookup "
             f"{rows['take_axis0']['lookup_cycles']} cycles, "
             f"{rows['take_axis0']['blocks']} blocks")
    # the cluster tables' default plans, and on the card their staging share
    for kname in ("take_two_level", "take_axis0_axis1"):
        rows[kname]["plan"] = A.table_plan(inp["nt"])._asdict()
        if on_card:
            rows[kname].update(table_spans(calls[kname][0],
                                           calls[kname][2][0]))
            emit(f"   {kname} default plan {rows[kname]['plan']}: stage "
                 f"{rows[kname]['stage_cycles']} lookup "
                 f"{rows[kname]['lookup_cycles']} cycles, "
                 f"{rows[kname]['clusters']} clusters")
    res = {"device": name, "timer": "cuda events" if on_card
           else "host clock", "n": n, "nt": inp["nt"], "e": e,
           "m": inp["m"], "reps": reps, "torch_ms": torch_ms}
    res["by_cluster"] = cluster_sweep(inp, emit)
    res["by_slab"] = slab_sweep(inp, emit)
    res["read_rates"] = read_rates(
        inp, {k: rows[k]["ms"] for k in RATED}, emit)
    if on_card:
        res["take_scalar_cycles"] = _cycles_section(inp, emit)
        khz = res["take_scalar_cycles"]["sm_clock_khz"]
        for kname in ("take_two_level", "take_axis0_axis1"):
            # every read of the launch over cluster 0's lookup span
            rows[kname]["lookup_reads_per_s"] = \
                e / (rows[kname]["lookup_cycles"] / (1e3 * khz))
    for kname, row in rows.items():
        row["launches"] = A.launch_counts[kname] - before[kname]
    res["kernels"] = {k: rows[k] for k in A.KERNELS}
    res["previous"] = {k: rows[k] for k in A.PREVIOUS}
    return res


SWEEP = (2, 4, 8)  # the cluster sizes `cluster_sweep` tries


def table_spans(kern: Callable, args: tuple, reps: int = 5, **kw) -> dict:
    """Cluster 0's staging and lookup spans of C2 or V4 in SM cycles (the
    median of `reps` launches), and the clusters launched, on the card."""
    cyc = torch.zeros(3, dtype=torch.int64, device=args[0].device)
    spans = []
    for _ in range(reps):
        kern(*args, cycles=cyc, **kw)
        spans.append(cyc.tolist())
    stage, lookup, clusters = (sorted(c)[len(c) // 2] for c in zip(*spans))
    return {"stage_cycles": stage, "lookup_cycles": lookup,
            "stage_share": stage / (stage + lookup), "clusters": clusters}


def _sweep(inp: dict, kname: str, configs: Dict[str, dict], spans: Callable,
           sizes: Callable, emit) -> dict:
    """`kname` at each of `configs` (label -> its keyword arguments): held
    bit-equal to its plain version, then timed; on the card also
    `spans(args, **kw)`; and `sizes(kw, row)` (its shared memory, and the
    bytes staged where the row has the spans)."""
    on_card = inp["table"].device.type == "cuda"
    kern, plain, args = _calls(inp)[kname]
    out = {}
    for label, kw in configs.items():
        def fn(*a, _kw=kw):
            return kern(*a, **_kw)
        _require(torch.equal(fn(*args[0]), plain(*args[0])),
                 f"{kname}: differs from its plain version at {kw}, "
                 f"n={inp['n']} E={inp['e']} M={inp['m']}")
        row = {"ms": time_ms(fn, args)}
        if on_card:
            row.update(spans(args[0], **kw))
        row.update(sizes(kw, row))
        out[label] = row
        emit(f"   {kname} at {label}: {json.dumps(row)}")
    return out


def cluster_sweep(inp: dict, emit) -> dict:
    """C2 and V4 at each of `SWEEP`'s cluster sizes whose shared memory
    holds the table (`_sweep`); on the card also their spans, clusters
    launched and bytes staged (each cluster stages the whole table)."""
    nt = inp["nt"]

    def sizes(kw, row):
        out = {"smem": A.table_plan(nt, kw["blocks"]).smem}
        if "clusters" in row:
            out["staged_bytes"] = row["clusters"] * 4 * nt
        return out
    configs = {str(k): {"blocks": k} for k in SWEEP if A.table_fits(nt, k)}
    return {kname: _sweep(inp, kname, configs,
                          functools.partial(table_spans, getattr(A, kname)),
                          sizes, emit)
            for kname in ("take_two_level", "take_axis0_axis1")}


# the lookups that make one random table read an index
RATED = ("take", "take_two_level", "take_two_level_chunks", "take2d",
         "take_axis0", "take_axis0_l2", "take_axis0_axis1",
         "take_axis0_axis1_l2")
SLAB_SWEEP = (32, 16)  # V2's slab widths `slab_sweep` tries


def take2d_spans(args: tuple, reps: int = 5) -> dict:
    """V1's load and select spans of warp 0 of block 0 in SM cycles and
    the blocks launched (the median of `reps` launches), on the card."""
    row = table_spans(A.take2d, args, reps)
    return {"load_cycles": row["stage_cycles"],
            "select_cycles": row["lookup_cycles"], "blocks": row["clusters"]}


def slab_spans(args: tuple, reps: int = 5, **kw) -> dict:
    """V2's staging and lookup spans of block 0 in SM cycles and the blocks
    launched (the median of `reps` launches), on the card."""
    row = table_spans(A.take_axis0, args, reps, **kw)
    row["blocks"] = row.pop("clusters")
    return row


def slab_sweep(inp: dict, emit) -> dict:
    """V2 at each slab width of `SLAB_SWEEP` that a block holds
    (`_sweep`); on the card also block 0's spans and the bytes staged
    (each block its slab)."""
    nt = inp["nt"]

    def sizes(kw, row):
        out = {"smem": A.slab_plan(nt, **kw).smem}
        if "blocks" in row:
            out["staged_bytes"] = row["blocks"] * out["smem"]
        return out
    configs = {str(c): {"cols": c} for c in SLAB_SWEEP if A.slab_fits(nt, c)}
    return _sweep(inp, "take_axis0", configs, slab_spans, sizes, emit)


def read_rates(inp: dict, ms: Dict[str, float], emit) -> dict:
    """Each lookup of `ms` (name -> its ms on E indices; `RATED`) timed on
    twice the indices, each set followed by the next (the last by the
    first), held bit-equal first. With its time on E indices this gives
    the rate of its reads apart from what a launch costs whatever its size
    (launch, staging, tail; `rate_parts`): E / (t(2E) - t(E)) reads a
    second, and 2 t(E) - t(2E) ms fixed."""
    calls = _calls(inp)
    out = {}
    for kname in ms:
        kern, plain, args = calls[kname]
        twice = [(a[0], torch.cat([a[1], b[1]]))
                 for a, b in zip(args, args[1:] + args[:1])]
        hold(kname, kern, plain, twice[0], " on twice the indices")
        reads = args[0][1].numel()
        t2 = time_ms(kern, twice)
        added, fixed = rate_parts(ms[kname], t2)
        out[kname] = {"ms": ms[kname], "ms_twice": t2, "fixed_ms": fixed,
                      "reads_per_s": reads / (1e-3 * added)
                      if added > 0 else None}
        emit(f"   {kname} on {reads} and {2 * reads} indices: "
             f"{json.dumps(out[kname])}")
    return out


def _cycles_section(inp: dict, emit) -> dict:
    """C3's cycles on random indices and, where the table spans several
    blocks, on indices that all fall in block 0's slice and all in the
    others', with the times they mean at the card's rated clock."""
    n, table = inp["n"], inp["table"]
    tile = min(TILE, inp["e"])
    plan = A.scalar_plan(n, tile)
    khz = A.sm_clock_khz(table.device)
    gen = torch.Generator(device=table.device).manual_seed(7)
    cases = {"random": inp["idx"][0][:tile]}
    if plan.blocks > 1:
        for case, lo, hi in (("local", 0, plan.head),
                             ("remote", plan.head, n)):
            cases[case] = torch.randint(lo, hi, (tile,), generator=gen,
                                        device=table.device,
                                        dtype=torch.int32)
    out = {"plan": plan._asdict(), "sm_clock_khz": khz, "elements": tile}
    for case, idx in cases.items():
        c = scalar_cycles(table, idx)
        c["stage_ms"] = c["stage_cycles"] / khz
        c["walk_ms"] = c["walk_cycles"] / khz
        out[case] = c
        emit(f"   take_scalar cycles, {case} indices: stage "
             f"{c['stage_cycles']} walk {c['walk_cycles']} "
             f"({c['cycles_per_element']:.2f} an element), local "
             f"{c['local_reads']} remote {c['remote_reads']}; cluster of "
             f"{plan.blocks}, {khz} kHz")
    return out


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=100_000,
                    help="table entries")
    ap.add_argument("e", type=int, nargs="?", default=1_600_000,
                    help="indices")
    ap.add_argument("reps", type=int, nargs="?", default=10)
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions on the host")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    res = run(args.n, args.e, args.reps, device=args.device, seed=args.seed,
              emit=lambda s: print(s, flush=True))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
