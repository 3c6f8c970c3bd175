#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--n NODES]

1. Requires a CUDA device and prints the card's name and power limit.
   TF32 is switched off for matmuls and cuDNN, so every float32 product
   (the plain versions included) runs in full float32.
2. Builds both kernel libraries with nvcc, side by side: the InfoNCE
   kernels (`rlap_tpu_torch/csrc/infonce.cu`) and the access probes
   (`rlap_tpu_torch/csrc/access.cu`: the eight, and the previous designs
   of C2, C3, C4, V2 and V4), and prints ptxas's resource lines
   (registers, spills, static shared memory) and remarks, one line each
   for the redesigned C2, C3, C4, V1, V2 and V4 kernels, the dynamic
   shared memory of the tensor-core kernels, of the C2, C3 and V4
   clusters and of V2's slabs, and how many
   `wgmma` (HGMMA) and full
   waits behind them (WARPGROUP.DEPBAR) the machine code of each `wgmma`
   kernel holds.
3. Holds each InfoNCE kernel against its plain PyTorch version: n=2048
   f=128 and ragged n=1000 f=100, masked and unmasked, tau 0.2 and 0.5;
   the ragged shapes n=70 f=300, n=129 f=100, n=4097 f=72, n=500 f=50
   (rows not 16-byte aligned) and n=333 f=1000; the main path's shape;
   and the CLI phase's GRACE shape, n=19717 f=128, masked and unmasked.
   Values within rtol 1e-5 / atol 1e-5, gradients within rtol 1e-4 /
   atol 1e-6. Times each kernel and its plain version with CUDA events,
   and the forward beside the yardstick F.cross_entropy(a @ b.T / tau,
   arange(n)) at n=16384, which it must beat. On alike rows (spread 0.03
   and 0.003), and for one training step on a small graph, holds the
   kernels against float64, relative to the largest entry: within 1e-4,
   except dB at spread 0.003, within 2e-4 (the rounding of its float32
   coefficients reaches it through its column sums), with the error of the
   plain float32 versions and of the plain emulation of the kernels' 3xTF32
   arithmetic beside.
4. Probe phase. Holds the eight access kernels and the previous designs
   of C2, C3, C4, V2 and V4 (`take_two_level_chunks`, `take_scalar_l2`,
   `scatter_min_atomic`, `take_axis0_l2`, `take_axis0_axis1_l2`) bit-equal
   against their plain versions at a ragged shape (n=1000, E=12345, M=97
   index tiles; C3's cluster is 1 block), one launch counted per call;
   holds C1 and both designs of C2 (and V1, both designs of V2 and V4,
   and V3, on the stream's whole rows of 128), both scatter-mins and both
   scalar walks
   bit-equal
   on the index stream of the rLap selection on BA(n, m=8) (both
   endpoints of the canonical edge pool; C3 on its first 8192 gather
   indices, a cluster of 2) and times them beside torch's `index_select`
   and `scatter_reduce_`, with the atomics C4's merge leaves, and the
   selection itself as the port runs it in a view's first round; then
   drives the probe entry point `rlap_tpu_torch.bench.probe_access.run`
   at n=100000, E=1600000 with the access counts set to 0 just before
   and read just after. The entry point holds each kernel bit-equal at
   that shape before it times it; holds C2 and V4 bit-equal at every
   cluster size of 2, 4 and 8 and times them there, with the clusters
   launched, the bytes staged and cluster 0's staging and lookup spans;
   holds V2
   bit-equal at slabs of 32 and 16 columns and times it there, with its
   spans; reads V1's load and select spans; times C1, V1 and both
   designs of C2, V2 and V4 again on twice the indices, for their rate of reads
   apart from launch, staging and tail; and reads C3's
   staging and walk cycles and its local and remote
   reads on random, block-0-only and other-block-only indices.
5. Checks that `approximate_cholesky(barabasi_albert(2000, 8), rng.key(0),
   400)` runs with no `device=` anywhere.
6. Drives the training path: GraceTrainer(Compose([RLap(0.2),
   FeatureMasking(0.3)]) x 2, hidden 128, 2 layers) on BA(n, m=8) with
   128-d features, 1 warm-up and 3 timed steps, with the InfoNCE counts
   set to 0 just before and read just after, and checks that each view
   removed int(0.2 n) nodes, that the losses are finite, and that each
   InfoNCE kernel ran twice per step. Then one more step under the
   profiler (`rlap_tpu_torch.utils.tracing`), with spans around the views,
   the forward, the loss, the backward and the Adam update: from its
   Chrome trace, the card's busy time (the union of kernel, memcpy and
   memset intervals in the step's span), its idle share and the five
   device ops with the most time. The trace must hold CUDA kernels and an
   InfoNCE kernel. A small profiled region runs first, so that CUPTI's
   start-up is not in the step.
7. Bench phase, at the main path's n: `rlap_tpu_torch.bench.
   rlap_throughput.run` (edges/s of `eliminate` at t = n/2 against the
   C++ oracle on the host, built from `rlap_tpu_torch/native/oracle.cc`;
   each call must remove n/2 nodes; then its speed-of-light model,
   `rlap_tpu_torch/bench/roofline.py`: the five primitive prices measured
   on the card at a table of n and E = the graph's directed edges, the
   gather through C1 `take` and the scatter through C4 `scatter_min`,
   both held bit-equal to their plain versions at E and 2E first and
   launched on the card for every timed call; the prices must be finite
   and positive, the model's ms over the measured call's must lie in
   (0, 1] (the model is a floor at today's measured prices: above 1, the
   message names the price with the largest share, to be measured again),
   and the replay's rounds within 3 of the median of the calls'; the
   prices, the fraction, the breakdown by category and by price, the
   card's busy time in one traced call and the host time of the prices
   and of the replay are printed on their own lines with the card's name
   and power limit) and
   `rlap_tpu_torch.bench.epoch.run` (GRACE epochs with separate and with
   paired rLap views, 3 timed after the first), with the InfoNCE counts
   set to 0 just before and read just after: each kernel twice an epoch
   in both variants, and every view must remove int(0.2 n) nodes.
8. The recipe CLI phase, through `rlap_tpu_torch.cli.run.run_one` with no
   `device=` (the synthetic stand-ins, as no dataset files are there):
   GRACE on the PUBMED stand-in (n=19717, f=500) with EdgeDroppingPR
   views, hidden 128, 3 epochs, with the InfoNCE counts set to 0 just
   before and read just after (each kernel twice an epoch); MVGRL on the
   PUBMED stand-in with PPR diffusion views (the 8192-node subsample
   runs; both views must keep at least 8192 nodes; the PPR build is
   timed); CCA-SSG on the CORA stand-in with rLap views; GraphCL and BGRL
   on the MUTAG stand-in with rLap views. Each run's JSONL must hold every
   event, finite losses and accuracies in [0, 1]; each epoch is timed
   on its own, apart from the trainer's set-up; MVGRL's last epoch is
   run once more afterwards under the profiler, for its idle share and
   top device ops. Then every one of the
   17 registry names and the 10 CCA-SSG functions builds views of the
   CORA stand-in (n=2708, f=512) on the card, each checked (indices in
   range, padding = sentinel with weight 0, symmetric unless a diffusion
   or an adaptive drop, finite weights) and timed, and
   `rlap_tpu_torch.bench.augmentors.bench_all` measures each name's
   latency and device memory there; and the InfoNCE kernels are timed at
   GRACE's shape, n=19717, f=128.
9. The sharded phase (`rlap_tpu_torch.parallel`), at the main path's
   BA(n, m=8), f=128, in spawned ranks: world 1 over NCCL, then world 2
   on the one card over gloo with CUDA tensors (NCCL takes one card a
   rank). At each, in the same ranks, the dry run of `dryrun_multichip`
   (the distributed rLap at n=4096, then 3 GRACE steps whose views come
   from `eliminate_sharded`, with the InfoNCE counts of each rank set to 0
   just before the steps and read just after: each kernel twice a step;
   losses and parameters equal on every rank), and `sharded_checks`: the
   sharded `spmm` against the local one, 3 `GraceTrainer(mesh=...)` steps
   against the local trainer's losses, and a sharded rLap view (t = 0.2 n)
   and call (t = n/2), each removing exactly t nodes with a symmetric,
   positive union of the shards that keeps no eliminated node. Prints
   each rank's step, views and rLap ms a view, and the edges/s of the
   t = n/2 call beside the single-device `eliminate`'s.
10. Prints one JSON line of the probe, one of the main path, one of each
   bench, one of the CLI phase, one of the sharded phase, one of all
   eleven kernels and the seven other designs (each row with the card's
   name and power limit), the nvidia-smi line, and last
   {"ok": true, "device": {...}}. Any failed check raises and the script
   exits non-zero.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from rlap_tpu_torch.augment.base import Compose
from rlap_tpu_torch.augment.cca_registry import (CCA_AUGMENTORS,
                                                 make_cca_augmentor)
from rlap_tpu_torch.augment.diffusion import PPRDiffusion
from rlap_tpu_torch.augment.feature import FeatureMasking
from rlap_tpu_torch.augment.registry import (AUGMENTOR_NAMES,
                                             make_augmentor_pair)
from rlap_tpu_torch.augment.rlap import RLap
from rlap_tpu_torch.bench import augmentors as AB
from rlap_tpu_torch.bench import epoch as EB
from rlap_tpu_torch.bench import probe_access as P
from rlap_tpu_torch.bench import rlap_throughput as RT
from rlap_tpu_torch.bench.time_infonce import cuda_ms
from rlap_tpu_torch.cli.run import run_one
from rlap_tpu_torch.core import graph as G
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.data.loaders import load_dataset
from rlap_tpu_torch.data.synthetic import barabasi_albert
from rlap_tpu_torch.models.bgrl import BGRLTrainer
from rlap_tpu_torch.models.cca_ssg import CCASSGTrainer
from rlap_tpu_torch.models.grace import GraceTrainer
from rlap_tpu_torch.models.graphcl import GraphCLTrainer
from rlap_tpu_torch.models.mvgrl import MVGRLTrainer
from rlap_tpu_torch.objectives.contrast import DualBranchContrast
from rlap_tpu_torch.ops import _build
from rlap_tpu_torch.ops import access as A
from rlap_tpu_torch.ops import infonce_fused as K
from rlap_tpu_torch.ops.rlap import (_entry, _select, approximate_cholesky,
                                     eliminate)
from rlap_tpu_torch.ops.spmm import gcn_norm, spmm
from rlap_tpu_torch.parallel import dryrun as DR
from rlap_tpu_torch.parallel.launch import launch
from rlap_tpu_torch.parallel.mesh import (broadcast_graph, make_mesh,
                                          shard_graph)
from rlap_tpu_torch.parallel.partition import partition_edges_by_sender
from rlap_tpu_torch.parallel.rlap_dist import eliminate_sharded
from rlap_tpu_torch.utils import tracing
from rlap_tpu_torch.utils.config import ExperimentConfig
from rlap_tpu_torch.utils.logging import read_metrics

# published H100 SXM peaks (NVIDIA data sheet): dense TF32 on the tensor
# cores, float32 outside them, and HBM bandwidth
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
STEPS = 3
FRAC = 0.2
LIBRARY_N = 16384
PROBE_N, PROBE_E, PROBE_REPS = 100_000, 1_600_000, 10
RAGGED_N, RAGGED_E, RAGGED_M = 1000, 12_345, 97
# n, f, tau: two feature chunks and a half-empty row block; one row past a
# block of 128; one column past a tile of 64; rows that are not 16-byte
# aligned; eight feature chunks
RAGGED_CASES = ((70, 300, 0.2), (129, 100, 0.2), (4097, 72, 0.2),
                (500, 50, 0.5), (333, 1000, 0.2))
# the rows of the PUBMED stand-in, which the CLI phase's GRACE run feeds the
# InfoNCE kernels at f=128: five rows past a whole block of 32
CLI_GRACE_N = 19717
REPLACES = {
    "infonce_fwd": "rlap_tpu/ops/infonce_pallas.py:37",
    "infonce_bwd_da": "rlap_tpu/ops/infonce_pallas.py:86",
    "infonce_bwd_db": "rlap_tpu/ops/infonce_pallas.py:104",
    "take": "tools/probe_access.py:139",
    "take_two_level": "tools/probe_access.py:180",
    "take_two_level_chunks": "tools/probe_access.py:180",
    "take_scalar": "tools/probe_access.py:215",
    "scatter_min": "tools/probe_access.py:251",
    "take_scalar_l2": "tools/probe_access.py:215",
    "scatter_min_atomic": "tools/probe_access.py:251",
    "take2d": "tools/probe_access2.py:53",
    "take_axis0": "tools/probe_access2.py:102",
    "take_axis0_l2": "tools/probe_access2.py:102",
    "take_axis1": "tools/probe_access2.py:143",
    "take_axis0_axis1": "tools/probe_access2.py:194",
    "take_axis0_axis1_l2": "tools/probe_access2.py:194",
}
TOL = {"infonce_fwd": (1e-5, 1e-5), "infonce_bwd_da": (1e-4, 1e-6),
       "infonce_bwd_db": (1e-4, 1e-6)}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def close(name: str, got: torch.Tensor, ref: torch.Tensor, rtol: float,
          atol: float) -> float:
    """Max abs error; raises if any element is outside atol + rtol |ref|."""
    err = (got - ref).abs()
    worst = float(err.max())
    bad = int((err > atol + rtol * ref.abs()).sum())
    require(bad == 0 and bool(torch.isfinite(got).all()),
            f"{name}: {bad} elements outside rtol {rtol} atol {atol}, "
            f"max abs err {worst}")
    return worst


def bound(name: str, n: int, f: int) -> dict:
    """The least time on the card, whatever the implementation. Each input
    is read once and each output written once at the HBM rate; the forward
    does 2 n^2 f and each gradient 4 n^2 f useful FLOPs, at the TF32
    tensor-core peak. A kernel that takes three TF32 passes to keep float32
    accuracy can reach a third of that. `fp32_fma_bound_ms` is the same
    work at the float32 FMA peak, the bound of a kernel that stays outside
    the tensor cores."""
    if name == "infonce_fwd":
        nbytes, flops = 4 * (2 * n * f + 2 * n), 2.0 * n * n * f
    else:
        nbytes, flops = 4 * (3 * n * f + 2 * n), 4.0 * n * n * f
    t_bytes, t_ops = nbytes / HBM_BYTES, flops / TF32_FLOPS
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations",
                fp32_fma_bound_ms=1e3 * max(t_bytes, flops / FP32_FLOPS))


def inputs(n: int, f: int, masked: bool, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = K.l2norm(torch.randn(n, f, generator=gen, device="cuda"))
    b = K.l2norm(torch.randn(n, f, generator=gen, device="cuda"))
    if masked:
        m = (torch.rand(n, generator=gen, device="cuda") < 0.85).float()
    else:
        m = torch.ones(n, device="cuda")
    g = -m / m.sum().clamp_min(1.0)  # d loss / d out of the masked mean
    return a.contiguous(), b.contiguous(), m.bool(), g.contiguous()


def check_case(n, f, masked, tau, errs, seed):
    a, b, _m, g = inputs(n, f, masked, seed)
    out, lse = K.infonce_fwd(a, b, tau)
    out_p, lse_p = K.infonce_fwd_plain(a, b, tau)
    rt, at = TOL["infonce_fwd"]
    e = max(close(f"fwd out n={n} f={f} tau={tau}", out, out_p, rt, at),
            close(f"fwd lse n={n} f={f} tau={tau}", lse, lse_p, rt, at))
    errs["infonce_fwd"] = max(errs["infonce_fwd"], e)
    for name, kern, plain in (
            ("infonce_bwd_da", K.infonce_bwd_da, K.infonce_bwd_da_plain),
            ("infonce_bwd_db", K.infonce_bwd_db, K.infonce_bwd_db_plain)):
        rt, at = TOL[name]
        e = close(f"{name} n={n} f={f} tau={tau} masked={masked}",
                  kern(a, b, lse_p, g, tau), plain(a, b, lse_p, g, tau),
                  rt, at)
        errs[name] = max(errs[name], e)
    torch.cuda.synchronize()


def check_autograd(n, f, tau, seed):
    """infonce_fused (kernels) against infonce_fused_plain (autograd)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x1 = torch.randn(n, f, generator=gen, device="cuda")
    x2 = torch.randn(n, f, generator=gen, device="cuda")
    mask = torch.rand(n, generator=gen, device="cuda") < 0.85
    res = []
    for fn in (K.infonce_fused, K.infonce_fused_plain):
        a = x1.clone().requires_grad_(True)
        b = x2.clone().requires_grad_(True)
        loss = fn(a, b, tau=tau, anchor_mask=mask)
        loss.backward()
        res.append((loss.detach(), a.grad, b.grad))
    close("infonce_fused loss", res[0][0], res[1][0], 1e-5, 1e-5)
    close("infonce_fused dA", res[0][1], res[1][1], 1e-4, 1e-6)
    close("infonce_fused dB", res[0][2], res[1][2], 1e-4, 1e-6)
    torch.cuda.synchronize()


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Max abs error relative to the largest entry of the reference."""
    return float((got.double() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


def check_against_float64(n: int, f: int, spread: float, seed: int,
                          bars: dict) -> None:
    """Rows alike (a shared direction plus `spread` noise), as a fresh
    encoder's embeddings are: the gradients cancel nearly equal terms, so
    an element-wise bar between two float32 sums is the wrong test. Each
    kernel must be within `bars[name]` of the largest entry of a float64
    result. Beside each kernel's error: the plain float32 version's, and
    that of the plain emulation of the kernel's arithmetic, which tells a
    loss of precision from a fault."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = torch.randn(1, f, generator=gen, device="cuda")
    a, b = (K.l2norm(c + spread * torch.randn(n, f, generator=gen,
                                              device="cuda")).contiguous()
            for _ in range(2))
    g = torch.full((n,), -1.0 / n, device="cuda")
    a64, b64, g64 = a.double(), b.double(), g.double()
    out64, lse64 = K.infonce_fwd_plain(a64, b64, 0.2)
    lse = lse64.float().contiguous()
    refs = {"infonce_fwd": out64,
            "infonce_bwd_da": K.infonce_bwd_da_plain(a64, b64, lse64, g64,
                                                     0.2),
            "infonce_bwd_db": K.infonce_bwd_db_plain(a64, b64, lse64, g64,
                                                     0.2)}
    got = {"infonce_fwd": (K.infonce_fwd(a, b, 0.2)[0],
                           K.infonce_fwd_plain(a, b, 0.2)[0]),
           "infonce_bwd_da": (K.infonce_bwd_da(a, b, lse, g, 0.2),
                              K.infonce_bwd_da_plain(a, b, lse, g, 0.2)),
           "infonce_bwd_db": (K.infonce_bwd_db(a, b, lse, g, 0.2),
                              K.infonce_bwd_db_plain(a, b, lse, g, 0.2))}
    torch.cuda.synchronize()
    emulated = {
        "infonce_fwd": K.infonce_fwd_3xtf32_plain(a, b, 0.2)[0],
        "infonce_bwd_da": K.infonce_bwd_da_3xtf32_plain(a, b, lse, g, 0.2),
        "infonce_bwd_db": K.infonce_bwd_db_3xtf32_plain(a, b, lse, g, 0.2)}
    report = {}
    for name, (kern, plain) in got.items():
        report[name] = {"kernel": rel_err(kern, refs[name]),
                        "plain_f32": rel_err(plain, refs[name]),
                        "emulation_3xtf32": rel_err(emulated[name],
                                                    refs[name]),
                        "bar": bars[name]}
        require(report[name]["kernel"] <= bars[name],
                f"{name} against float64 at n={n} spread={spread}: "
                f"{report[name]}")
    print(f"against float64, n={n} spread={spread}, error / max entry: "
          f"{json.dumps(report)}", flush=True)


def kernel_phase(n_main: int, f_main: int) -> dict:
    errs = {name: 0.0 for name in K.KERNELS}
    seed = 0
    for n, f in ((2048, 128), (1000, 100)):
        for masked in (False, True):
            for tau in (0.2, 0.5):
                seed += 1
                check_case(n, f, masked, tau, errs, seed)
    for n, f, tau in RAGGED_CASES:
        seed += 1
        check_case(n, f, True, tau, errs, seed)
    check_autograd(1000, 100, 0.2, 99)
    check_case(n_main, f_main, False, 0.2, errs, 100)
    for masked in (False, True):
        seed += 1
        check_case(CLI_GRACE_N, f_main, masked, 0.2, errs, seed)
    check_against_float64(20000, f_main, 0.03, 101,
                          bars={name: 1e-4 for name in K.KERNELS})
    # rows nearly equal: the plain float32 sums lose 1e-4 here, and dB's
    # column sums carry the rounding of its float32 coefficients into the
    # result, which leaves it less room: it is held to 2e-4
    check_against_float64(20000, f_main, 0.003, 102,
                          bars={"infonce_fwd": 1e-4, "infonce_bwd_da": 1e-4,
                                "infonce_bwd_db": 2e-4})
    print(f"kernel checks passed; max abs err {json.dumps(errs)}",
          flush=True)

    a, b, _m, g = inputs(n_main, f_main, False, 7)
    _, lse = K.infonce_fwd_plain(a, b, 0.2)
    calls = {
        "infonce_fwd": (lambda: K.infonce_fwd(a, b, 0.2),
                        lambda: K.infonce_fwd_plain(a, b, 0.2)),
        "infonce_bwd_da": (lambda: K.infonce_bwd_da(a, b, lse, g, 0.2),
                           lambda: K.infonce_bwd_da_plain(a, b, lse, g, 0.2)),
        "infonce_bwd_db": (lambda: K.infonce_bwd_db(a, b, lse, g, 0.2),
                           lambda: K.infonce_bwd_db_plain(a, b, lse, g, 0.2)),
    }
    rows = {}
    for name, (kern, plain) in calls.items():
        rows[name] = dict(ms=cuda_ms(kern, 3), plain_ms=cuda_ms(plain, 3),
                          **bound(name, n_main, f_main))
        print(f"{name} at n={n_main} f={f_main}: {json.dumps(rows[name])}",
              flush=True)
    del a, b, g, lse

    # the yardstick: one library call for the forward's function, at a
    # size where the n x n logits fit
    a, b, _m, _g = inputs(LIBRARY_N, f_main, False, 8)
    target = torch.arange(LIBRARY_N, device="cuda")
    lib_ms = cuda_ms(lambda: F.cross_entropy(a @ b.T / 0.2, target,
                                             reduction="none"), 5)
    fwd_small = cuda_ms(lambda: K.infonce_fwd(a, b, 0.2), 5)
    print(f"yardstick F.cross_entropy at n={LIBRARY_N}: {lib_ms} ms; "
          f"infonce_fwd {fwd_small} ms", flush=True)
    require(fwd_small < lib_ms,
            f"infonce_fwd takes {fwd_small} ms at n={LIBRARY_N}, the library "
            f"call {lib_ms} ms")
    del a, b
    torch.cuda.empty_cache()
    for name in K.KERNELS:
        rows[name]["max_abs_err"] = errs[name]
        rows[name]["library_ms"] = lib_ms if name == "infonce_fwd" else None
        rows[name]["library_n"] = LIBRARY_N if name == "infonce_fwd" else None
        rows[name]["ms_at_library_n"] = (fwd_small if name == "infonce_fwd"
                                         else None)
    return rows


def ptxas_usage(log: str, names) -> dict:
    """Registers, shared memory and spills of each kernel in `names`, from
    the `-Xptxas -v` output of a build."""
    usage, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            current = next((k for k in names if k in line), None)
        elif current is not None and ("Used" in line or "spill" in line):
            usage.setdefault(current, []).append(
                line.split(":", 1)[-1].strip())
    require(set(usage) == set(names), f"ptxas printed no resource line for "
            f"{set(names) - set(usage)}")
    return {k: "; ".join(dict.fromkeys(v)) for k, v in usage.items()}


def probe_phase(g) -> tuple:
    """The access kernels: ragged check, the rLap selection's index stream,
    then the probe entry point with its launches counted. Returns (the
    entry point's result, launches per kernel in its run)."""
    errs = P.check(P.make_inputs(RAGGED_N, RAGGED_E, RAGGED_M, 1, "cuda", 1))
    print(f"access kernels and previous variants bit-equal to their plain "
          f"versions at n={RAGGED_N} E={RAGGED_E} M={RAGGED_M} (C3: a "
          f"cluster of {A.scalar_plan(RAGGED_N, P.TILE).blocks}): max abs "
          f"err {json.dumps(errs)}", flush=True)

    # _select gathers pack[dst] and scatter-mins it into nmin[src], over
    # both directions of every pool edge
    n, t = g.num_nodes, int(FRAC * g.num_nodes)
    s, r, _w, _t = _entry(g, t)
    src = torch.cat([s, r]).to(torch.int32)
    dst = torch.cat([r, s]).to(torch.int32)
    gen = torch.Generator(device="cuda").manual_seed(2)
    prio = torch.randint(0, 1 << 30, (n,), generator=gen,
                         device="cuda", dtype=torch.int32)
    stream = P.time_stream(prio, dst, src, A.take(prio, dst), PROBE_REPS)
    # beside it, the selection as the port runs it in the first round of a
    # view: int64 priorities, and only the edges with both ends pending
    pos = torch.empty(n, dtype=torch.int64, device="cuda")
    pos[torch.randperm(n, generator=gen, device="cuda")] = torch.arange(
        n, device="cuda")
    pending = pos < t
    prio64 = torch.bincount(torch.cat([s, r]), minlength=n) * (n + 1) + pos
    stream["select_round1_ms"] = cuda_ms(
        lambda: _select(s, r, pending, prio64), 10)
    stream["select_round1_indices_scanned"] = 2 * int(
        (pending[s] & pending[r]).sum())
    stream["select_round1_selected"] = int(
        _select(s, r, pending, prio64).sum())
    stream["take_scalar_cluster"] = A.scalar_plan(n, P.TILE).blocks
    stream["take_two_level_plan"] = A.table_plan(-(-n // A.LANES)
                                                 * A.LANES)._asdict()
    print(f"rlap_select_stream BA(n={n}, m=8), C1, V1, V3, both designs of "
          f"C2, V2 and V4, both scatter-mins and both scalar walks "
          f"bit-equal: "
          f"{json.dumps(stream)}", flush=True)

    A.reset_launch_counts()
    res = P.run(PROBE_N, PROBE_E, PROBE_REPS,
                emit=lambda line: print(line, flush=True))
    launches = dict(A.launch_counts)
    cyc = res["take_scalar_cycles"]
    parts = []
    for case in ("random", "local", "remote"):
        c = cyc[case]
        parts.append(f"{case} stage {c['stage_cycles']} walk "
                     f"{c['walk_cycles']} ({c['cycles_per_element']:.2f} an "
                     f"element, {c['walk_ms']:.5f} ms), local "
                     f"{c['local_reads']} remote {c['remote_reads']}")
    print(f"take_scalar cycles at n={PROBE_N}, a cluster of "
          f"{cyc['plan']['blocks']} ({json.dumps(cyc['plan'])}), "
          f"{cyc['sm_clock_khz']} kHz: " + "; ".join(parts), flush=True)
    khz = cyc["sm_clock_khz"]
    for kname, rows in res["by_cluster"].items():
        print(f"{kname} by cluster at n={PROBE_N}: " + "; ".join(
            f"k={k} {r['ms']:.5f} ms, {r['clusters']} clusters, "
            f"{r['staged_bytes']} bytes staged, stage {r['stage_cycles']} "
            f"({r['stage_cycles'] / khz:.5f} ms) lookup "
            f"{r['lookup_cycles']} ({r['lookup_cycles'] / khz:.5f} ms) "
            f"cycles" for k, r in rows.items()), flush=True)
    print(f"take_axis0 by plan at n={PROBE_N}: " + "; ".join(
        f"{k} {r['ms']:.5f} ms, " + json.dumps(
            {x: y for x, y in r.items() if x != "ms"})
        for k, r in res["by_slab"].items()), flush=True)
    r = res["kernels"]["take2d"]
    print(f"take2d {r['ms']:.5f} ms (bound "
          f"{r['bound_ms']:.5f}): warp 0 of block 0 load "
          f"{r['load_cycles']} select {r['select_cycles']} cycles, "
          f"{r['blocks']} blocks", flush=True)
    r = res["kernels"]["take_axis0"]
    print(f"take_axis0 default plan {json.dumps(r['plan'])}: {r['ms']:.5f} "
          f"ms, staging {r['stage_cycles']} of "
          f"{r['stage_cycles'] + r['lookup_cycles']} cycles, {r['blocks']} "
          f"blocks", flush=True)
    for name in ("take_two_level", "take_axis0_axis1"):
        r = res["kernels"][name]
        print(f"{name} default plan {json.dumps(r['plan'])}: {r['ms']:.5f} "
              f"ms, staging {r['stage_cycles']} of "
              f"{r['stage_cycles'] + r['lookup_cycles']} cycles "
              f"({r['stage_share']:.3f}), {r['clusters']} clusters, "
              f"{r['lookup_reads_per_s']:.4g} reads/s over the lookup span",
              flush=True)
    print(f"read rates at n={PROBE_N} (E and 2E indices; reads/s of the "
          f"added E, and the fixed ms): " + "; ".join(
              f"{k} {r['ms']:.5f} / {r['ms_twice']:.5f} ms, "
              f"{r['reads_per_s']} reads/s, fixed {r['fixed_ms']:.5f}"
              for k, r in res["read_rates"].items()), flush=True)
    for name in A.NAMES:
        row = {**res["kernels"], **res["previous"]}[name]
        # the entry point's own comparison with the plain version is one
        # more launch than the timed and cycle-counting ones it reports
        require(row["launches"] > 0 and launches[name] == row["launches"] + 1,
                f"{name}: {launches[name]} launches counted, the probe "
                f"reports {row['launches']}")
        require(row["max_abs_err"] == 0, f"{name}: {row}")
        launches[name] = row["launches"]
    res["rlap_select_stream"] = stream
    return res, launches


def check_default_device() -> None:
    """A graph and a key made with no `device=` meet on the card."""
    g = barabasi_albert(2000, 8)
    out = approximate_cholesky(g, rng.key(0), 400)
    require(out.device.type == "cuda", f"output on {out.device}")
    isolated = int((G.degrees(out) == 0).sum()) - int(
        (G.degrees(g) == 0).sum())
    require(isolated == 400, f"removed {isolated} nodes, expected 400")
    print("approximate_cholesky with no device= ran on the card, removed "
          "400 of 2000 nodes", flush=True)


def sync_s() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def views_aug():
    return Compose([RLap(FRAC), FeatureMasking(0.3)])


def check_step_against_float64(f: int, n: int = 2000) -> None:
    """One training step on a small graph, through the kernels, against
    float64. The encoder runs once in float32; on its embeddings the
    kernels' loss (rtol 1e-5) and d loss / d embeddings (within 1e-4 of the
    largest entry, see `check_against_float64`) are held against the plain
    loss in float64. Both gradients are then pushed back through the same
    float32 encoder graph, so PReLU's kink sees the same activations, and
    the parameter gradients must agree within 1e-4 of their largest entry.
    (A float64 copy of the encoder can take the other side of the kink
    where an activation is within rounding of zero, which moves a gradient
    by a whole term.) The float32 plain loss's errors are printed beside.
    """
    g = barabasi_albert(n, 8, seed=1, device="cuda")
    x = np.random.default_rng(1).normal(size=(n, f)).astype(np.float32)
    g = g.replace(x=torch.as_tensor(x, device="cuda"))
    tr = GraceTrainer(views_aug(), views_aug(), hidden_dim=128,
                      num_layers=2, seed=0)
    tr.ensure_init(g)
    h = tr.model(*tr.views(g))
    tau = tr.contrast.tau

    def loss64(h1, h2):
        def one(a, b):
            out, _ = K.infonce_fwd_plain(K.l2norm(a), K.l2norm(b), tau)
            return -out.mean()
        return 0.5 * (one(h1, h2) + one(h2, h1))

    h64 = [t.detach().double().requires_grad_(True) for t in h]
    ref_loss = loss64(*h64)
    ref_dh = torch.autograd.grad(ref_loss, h64)
    ref_loss = ref_loss.detach().item()
    params = [p for _, p in tr.model.named_parameters()]
    names = [k for k, _ in tr.model.named_parameters()]
    ref_dp = torch.autograd.grad(h, params, [d.float() for d in ref_dh],
                                 retain_graph=True)
    worst = {}
    for label, fn in (("kernel", tr.contrast),
                      ("plain_f32", DualBranchContrast("infonce_batched",
                                                       tau=tau))):
        loss = fn(*h)
        dh = torch.autograd.grad(loss, h, retain_graph=True)
        dp = torch.autograd.grad(h, params, dh, retain_graph=True)
        errs = dict(zip(names, (rel_err(a, b.double())
                                for a, b in zip(dp, ref_dp))))
        worst[label + "_loss"] = abs(loss.item() - ref_loss) / ref_loss
        worst[label + "_dh"] = max(rel_err(a, b) for a, b in zip(dh, ref_dh))
        worst[label + "_param"] = max(errs, key=errs.get)
        worst[label + "_dparam"] = errs[worst[label + "_param"]]
    torch.cuda.synchronize()
    require(worst["kernel_loss"] <= 1e-5 and worst["kernel_dh"] <= 1e-4
            and worst["kernel_dparam"] <= 1e-4,
            f"train step against float64: {worst}")
    print(f"train step at n={n} against float64 (loss {ref_loss}), "
          f"worst error / max entry: {json.dumps(worst)}", flush=True)


def make_graph(n: int, f: int):
    t0 = time.perf_counter()
    g = barabasi_albert(n, 8, seed=0, device="cuda")
    x = np.random.default_rng(0).normal(size=(n, f)).astype(np.float32)
    g = g.replace(x=torch.as_tensor(x, device="cuda"))
    print(f"BA(n={n}, m=8): {int(g.num_edges)} directed edges, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return g


def profiled(label: str, body, phases=(), must_hold=None) -> dict:
    """Run `body()` once under `tracing.traced` in a span named `label`
    and read the card's work in it and in each span of `phases`. Fails if
    the span holds no CUDA kernel, or no kernel whose name holds
    `must_hold`: a trace that lost the card must not pass."""
    res = tracing.traced(label, body, phases)
    require(res["kernels"] > 0, f"{label}: no CUDA kernel in the trace")
    if must_hold is not None:
        require(any(must_hold in op["name"] for op in res["ops"]),
                f"{label}: no device op named *{must_hold}* in the trace")
    return {"traced_wall_ms": res["wall_ms"], "span_ms": res["span_ms"],
            "device_busy_ms": res["device_busy_ms"],
            "device_idle_share": res["device_idle_share"],
            "device_kernels": res["kernels"],
            "top_device_ops": res["top_device_ops"],
            "phases": {p: {k: r[k] for k in ("span_ms", "device_busy_ms",
                                             "device_idle_share")}
                       for p, r in res["phases"].items()}}


STEP_PHASES = ("views", "forward", "loss", "backward", "adam")


def traced_step(tr, g) -> dict:
    """One more main-path step under the profiler, each part in a span."""

    def step():
        tr.optimizer.zero_grad(set_to_none=True)
        with tracing.annotate("views"):
            g1, g2 = tr.views(g)
        with tracing.annotate("forward"):
            h1, h2 = tr.model(g1, g2)
        with tracing.annotate("loss"):
            loss = tr.contrast(h1, h2, node_mask=g1.node_mask)
        with tracing.annotate("backward"):
            loss.backward()
        with tracing.annotate("adam"):
            tr.optimizer.step()

    return profiled("main_path_step", step, STEP_PHASES, must_hold="infonce")


def main_path(g, f: int) -> tuple:
    n, edges = g.num_nodes, int(g.num_edges)
    num_remove = int(FRAC * n)
    input_isolated = int((G.degrees(g) == 0).sum())

    tr = GraceTrainer(views_aug(), views_aug(), hidden_dim=128,
                      num_layers=2, seed=0)
    t = sync_s()
    warm = tr.train_epoch(g)
    warm_s = sync_s() - t
    require(math.isfinite(warm), f"warm-up loss {warm}")

    K.reset_launch_counts()
    losses, view_ms, train_ms = [], [], []
    for _ in range(STEPS):
        t = sync_s()
        g1, g2 = tr.views(g)
        t_views = sync_s()
        losses.append(tr.train_step(g1, g2))
        t_step = sync_s()
        view_ms.append(1e3 * (t_views - t))
        train_ms.append(1e3 * (t_step - t_views))
        for view in (g1, g2):
            isolated = int((G.degrees(view) == 0).sum()) - input_isolated
            require(isolated == num_remove,
                    f"view removed {isolated} nodes, expected {num_remove}")
    launches = dict(K.launch_counts)
    for name in K.KERNELS:
        require(launches[name] == 2 * STEPS,
                f"{name} launched {launches[name]} times in {STEPS} steps")
    require(all(math.isfinite(v) for v in losses), f"losses {losses}")

    # breakdown of one more step into its parts (not part of the counts)
    key = rng.key(123, device="cuda")
    t = sync_s()
    _, removed, rounds = eliminate(g, key, num_remove, o_v="random",
                                   o_n="asc")
    rlap_ms = 1e3 * (sync_s() - t)
    require(removed == num_remove, f"eliminate removed {removed}")
    g1, g2 = tr.views(g)
    t = sync_s()
    h1, h2 = tr.model(g1, g2)
    t_enc = sync_s()
    loss = tr.contrast(h1, h2)
    t_loss = sync_s()
    loss.backward()
    t_bwd = sync_s()
    tr.optimizer.step()
    t_opt = sync_s()
    tr.optimizer.zero_grad(set_to_none=True)
    traced = traced_step(tr, g)
    step_ms = [v + s for v, s in zip(view_ms, train_ms)]
    print(f"traced step: {traced['traced_wall_ms']} ms under the profiler, "
          f"untraced steps {step_ms} ms; device idle share "
          f"{traced['device_idle_share']}", flush=True)
    summary = {
        "n": n, "m": 8, "f": f, "directed_edges": edges,
        "num_remove": num_remove, "steps": STEPS, "losses": losses,
        "warmup_step_s": warm_s,
        "views_ms": view_ms, "train_step_ms": train_ms,
        "step_ms": step_ms,
        "rlap_one_view_ms": rlap_ms, "rlap_rounds_one_view": rounds,
        "encoder_fwd_ms": 1e3 * (t_enc - t),
        "loss_fwd_ms": 1e3 * (t_loss - t_enc),
        "backward_ms": 1e3 * (t_bwd - t_loss),
        "adam_ms": 1e3 * (t_opt - t_bwd),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches,
        "device_busy_ms": traced["device_busy_ms"],
        "device_idle_share": traced["device_idle_share"],
        "top_device_ops": traced["top_device_ops"],
        "traced_step": traced,
    }
    return summary, launches


BENCH_EPOCHS = 3


ROUNDS_SLACK = 3  # the replay's rounds against the calls' median


def check_roofline(thr: dict, smi: str) -> None:
    """Print `rlap_throughput`'s speed-of-light model (the prices, the
    fraction, the breakdown by category and by price, and the card's busy
    time in one traced call beside it) with the card's name and power
    limit, and hold it: prices finite and positive, measured with `take`
    and `scatter_min` bit-equal and launched on the card (the checks at E
    and 2E, then a warm-up and `reps` calls at each size), the fraction in
    (0, 1] and the replay's rounds within `ROUNDS_SLACK` of the measured
    median."""
    prices, checks = thr["prices_ns"], thr["price_checks"]
    by_price = thr["roofline_by_price_ms"]
    print(f"roofline prices at n={checks['n']} E={checks['e']} (ns per "
          f"element; fixed ms a launch), {smi}: " + ", ".join(
              f"{k} {v} ({thr['price_fixed_ms'][k]})"
              for k, v in prices.items()), flush=True)
    print(f"roofline: model {thr['roofline_ms']} ms against "
          f"{thr['ms_per_call']} ms a call, fraction "
          f"{thr['roofline_fraction']}; one traced call {thr['traced_call_ms']}"
          f" ms, the card busy {thr['traced_call_device_busy_ms']} ms of it; "
          f"{thr['roofline_rounds']} rounds replayed, measured "
          f"{thr['rounds']}; {smi}", flush=True)
    print(f"roofline breakdown (ms; entry and exit "
          f"{thr['roofline_entry_exit_ms']}), {smi}: "
          f"{json.dumps(thr['roofline_breakdown_ms'])}; by price (ms, "
          f"elements): " + ", ".join(
              f"{k} {v} ({thr['roofline_elements'][k]})"
              for k, v in by_price.items()), flush=True)
    print(f"roofline host time: prices {thr['prices_s']} s, replay "
          f"{thr['replay_s']} s", flush=True)
    require(all(math.isfinite(v) and v > 0 for v in prices.values()),
            f"roofline prices not finite and positive: {prices}")
    timed = 2 + 2 * (checks["reps"] + 1)
    for kname in ("take", "scatter_min"):
        require(checks["max_abs_err"][kname] == 0
                and checks["launches"][kname] == timed,
                f"roofline prices: {kname} {checks}")
    require(thr["roofline_fraction"] > 0,
            f"roofline_fraction {thr['roofline_fraction']} not positive")
    top = max(by_price, key=by_price.get)
    require(thr["roofline_fraction"] <= 1,
            f"roofline_fraction {thr['roofline_fraction']} > 1: the call beat "
            f"the model at today's prices, so it does some of the work for "
            f"less than a price; the largest share is {top}'s ({by_price[top]}"
            f" of {thr['roofline_ms']} ms at {prices[top]} ns an element, "
            f"by price {by_price}): measure that price again from the faster "
            f"primitive")
    median = float(np.median(thr["rounds"]))
    require(abs(thr["roofline_rounds"] - median) <= ROUNDS_SLACK,
            f"replayed {thr['roofline_rounds']} rounds against measured "
            f"{thr['rounds']}")


def bench_phase(n: int, smi: str) -> dict:
    """The port's two benches at the main path's size, in this process:
    `rlap_throughput.run` (each call must remove n/2 nodes; its roofline
    held by `check_roofline`) and
    `epoch.run` at 3 timed epochs, with the InfoNCE counts set to 0 just
    before and read just after; each kernel must run twice an epoch in
    both variants, the first epoch included, and every view must remove
    int(0.2 n) nodes. Prints both results; returns the launches of each
    variant and the single-device `eliminate`'s edges/s."""
    t = time.perf_counter()
    thr = RT.run(n=n, device="cuda", reps=5)
    thr_s = time.perf_counter() - t
    require(thr["removed"] == min(n // 2, n - 1) and thr["device"] ==
            torch.cuda.get_device_name(0), f"rlap_throughput: {thr}")
    print(json.dumps({"rlap_throughput": thr}), flush=True)
    check_roofline(thr, smi)
    K.reset_launch_counts()
    t = time.perf_counter()
    ep = EB.run(n=n, frac=FRAC, epochs=BENCH_EPOCHS, device="cuda")
    print(f"bench phase parts: rlap_throughput {thr_s:.1f} s (its prices "
          f"{thr['prices_s']:.1f} s, its replay {thr['replay_s']:.1f} s), "
          f"epoch {time.perf_counter() - t:.1f} s", flush=True)
    launches = dict(K.launch_counts)
    by_variant = {v: ep[f"infonce_launches_{v}"]
                  for v in ("separate", "paired")}
    for name in K.KERNELS:
        for v, counts in by_variant.items():
            require(counts[name] == 2 * (BENCH_EPOCHS + 1),
                    f"epoch bench {v}: {name} launched {counts[name]} times "
                    f"in {BENCH_EPOCHS + 1} epochs")
        require(launches[name] == sum(c[name] for c in by_variant.values()),
                f"epoch bench: {name} launched {launches[name]} times")
    require(ep["removed_per_view"] == int(FRAC * n)
            and ep["views_checked"] == 4 * (2 * BENCH_EPOCHS + 1),
            f"epoch bench views: {ep}")
    print(json.dumps({"epoch_bench": ep}), flush=True)
    return by_variant, thr["value"]


CLI_EPOCHS = 3
SUBSAMPLE = 8192
NODE_EVENTS = {"config", "dataset", "metric:final_loss", "metric:epochs",
               "raw_feature_baseline", "test_run", "metric:wall_seconds"}
GRAPH_EVENTS = NODE_EVENTS - {"metric:epochs", "raw_feature_baseline"}
# views that are not symmetric by design: the diffusions keep each row's
# top k, and the adaptive drops give the two directions of a pair the
# probabilities of their own receivers (as the JAX package does)
NOT_SYMMETRIC = ("PPRDiffusion", "MarkovDiffusion", "rLapPPRDiffusion",
                 "EdgeDroppingDegree", "EdgeDroppingPR", "EdgeDroppingEVC",
                 "markovd", "pprd", "ed_deg", "ed_ppr", "ed_evc")


TRAINERS = (GraceTrainer, MVGRLTrainer, CCASSGTrainer, GraphCLTrainer,
            BGRLTrainer)


@contextlib.contextmanager
def epoch_times():
    """Yields (times, calls): `times` receives the ms of every
    `train_epoch` call of the recipes' trainers, between two
    synchronisations of the card, and `calls` the call itself (the
    unwrapped method and its arguments, trainer first)."""
    times, calls, saved = [], [], {cls: cls.train_epoch for cls in TRAINERS}

    def timed(fn):
        @functools.wraps(fn)  # keeps the signature checkpointed_fit reads
        def run(*args, **kw):
            t = sync_s()
            out = fn(*args, **kw)
            times.append(1e3 * (sync_s() - t))
            calls.append((fn, args, kw))
            return out
        return run

    for cls, fn in saved.items():
        cls.train_epoch = timed(fn)
    try:
        yield times, calls
    finally:
        for cls, fn in saved.items():
            cls.train_epoch = fn


def cli_run(cfg: ExperimentConfig, results_dir: str,
            traced: bool = False) -> dict:
    """One `run_one` on the card; checks its JSONL and returns the
    recipe's numbers. Each epoch is timed on its own: the first carries
    the one-time costs of the views (MVGRL's PPR build), `steady_epoch_ms`
    is the mean of the others, and `setup_ms` is what the trainer spends
    between the `dataset` and `final_loss` events outside its epochs
    (building the model and the augmentors). `load_s` is the time to the
    `dataset` event, `probes_s` the time after `final_loss`: the linear
    probes on the raw features and on the embeddings. With `traced`, the
    run's last epoch is run once more afterwards, on the trained trainer
    and under the profiler (`traced_epoch`)."""
    t = sync_s()
    with epoch_times() as (epoch_ms, calls):
        run_one(cfg, results_dir=results_dir)
    wall = sync_s() - t
    recs = list(read_metrics(f"{results_dir}/{cfg.run_name()}.jsonl"))
    events = {r["event"] if r["event"] != "metric"
              else f"metric:{r['name']}" for r in recs}
    want = NODE_EVENTS if cfg.recipe in ("grace", "mvgrl", "cca_ssg") \
        else GRAPH_EVENTS
    require(events == want, f"{cfg.recipe}: events {sorted(events)}")
    by = {e: [r for r in recs if (r["event"] if r["event"] != "metric"
                                  else f"metric:{r['name']}") == e]
          for e in events}
    loss = by["metric:final_loss"][0]
    epochs = loss["step"]
    require(math.isfinite(loss["value"]) and epochs == min(
        cfg.max_epochs, CLI_EPOCHS), f"{cfg.recipe}: final loss {loss}")
    acc = by["test_run"][0]["accuracy"]
    require(0.0 <= acc <= 1.0, f"{cfg.recipe}: accuracy {acc}")
    require(len(epoch_ms) == epochs,
            f"{cfg.recipe}: {len(epoch_ms)} epochs timed, {epochs} logged")
    fit_ms = 1e3 * (loss["ts"] - by["dataset"][0]["ts"])
    out = {"dataset": cfg.dataset, "augmentor": cfg.augmentor,
           "wall_s": wall, "run_wall_seconds":
               by["metric:wall_seconds"][0]["value"],
           "epochs": epochs, "epoch_ms": epoch_ms,
           "steady_epoch_ms": sum(epoch_ms[1:]) / max(epochs - 1, 1),
           "setup_ms": fit_ms - sum(epoch_ms),
           "load_s": by["dataset"][0]["ts"] - by["config"][0]["ts"],
           "probes_s": by["metric:wall_seconds"][0]["ts"] - loss["ts"],
           "final_loss": loss["value"], "test_accuracy": acc,
           "raw_feature_baseline": by["raw_feature_baseline"][0]["accuracy"]
           if "raw_feature_baseline" in by else None}
    if "dataset" in by and "num_nodes" in by["dataset"][0]:
        out["num_nodes"] = by["dataset"][0]["num_nodes"]
    if traced:
        fn, args, kw = calls[-1]
        prof = profiled("epoch", lambda: fn(*args, **kw))
        out["traced_epoch"] = prof
        out["device_idle_share"] = prof["device_idle_share"]
        out["top_device_ops"] = prof["top_device_ops"]
    print(f"cli {cfg.recipe}: {json.dumps(out)}", flush=True)
    return out


def check_view(name: str, g, out) -> None:
    n = out.num_nodes
    live = out.edge_mask
    require(out.senders.device.type == "cuda", f"{name}: on {out.device}")
    require(n == g.num_nodes and bool((out.senders >= 0).all())
            and bool((out.receivers >= 0).all())
            and int(out.senders.max()) <= n
            and int(out.receivers.max()) <= n
            and bool((out.receivers[live] < n).all()),
            f"{name}: indices out of range")
    require(bool((out.receivers[~live] == n).all())
            and bool((out.weights[~live] == 0).all()),
            f"{name}: padding slots are not (sentinel, weight 0)")
    require(bool(torch.isfinite(out.weights).all()),
            f"{name}: weights not finite")
    if name not in NOT_SYMMETRIC:
        a = G.to_dense(out)
        require(bool(torch.equal(a, a.T)), f"{name}: view not symmetric")


def registry_sweep() -> dict:
    """Views of every registry name and CCA-SSG function on the CORA
    stand-in, on the card, checked and timed (ms, each view's first
    call)."""
    g, _y, _meta = load_dataset("CORA")
    key = rng.key(5)
    ms = {}
    for name in AUGMENTOR_NAMES + ("rLapPPRDiffusion",):
        pair = make_augmentor_pair(name, 0.2, 0.2, num_nodes=g.num_nodes)
        times = []
        for i, aug in enumerate(pair):
            t = sync_s()
            out = aug(g, rng.fold_in(key, i))
            times.append(1e3 * (sync_s() - t))
            check_view(name, g, out)
        ms[name] = times
    for name in CCA_AUGMENTORS:
        aug = make_cca_augmentor(name, 0.2, 0.2)
        t = sync_s()
        out = aug(g, key)
        ms[f"cca:{name}"] = [1e3 * (sync_s() - t)]
        check_view(name, g, out)
    print(f"registry views of the CORA stand-in (n={g.num_nodes}, "
          f"f={g.x.shape[1]}), ms per view: {json.dumps(ms)}", flush=True)
    # the augmentor bench on the same graph: latency over 3 calls and the
    # device memory of one, from the caching allocator
    bench = {}
    for name, r in AB.bench_all(g, repeats=3).items():
        require(r["latency_ms_mean"] > 0 and r["peak_hbm_bytes"]
                >= r["hbm_args_bytes"] > 0, f"augmentor bench {name}: {r}")
        bench[name] = {k: r[k] for k in ("latency_ms_mean", "peak_hbm_bytes",
                                         "hbm_out_bytes", "hbm_temp_bytes")}
    print(f"augmentor bench on the CORA stand-in: {json.dumps(bench)}",
          flush=True)
    return {"n": g.num_nodes, "f": g.x.shape[1], "view_ms": ms,
            "augmentor_bench": bench}


def cli_phase() -> tuple:
    """The recipe CLI on the card, then the registry sweep. Returns (the
    phase's summary, InfoNCE launches in the GRACE run)."""
    summary = {}
    mvgrl_masks, ppr_ms = [], []
    views, augment = MVGRLTrainer.views, PPRDiffusion.augment

    def recording_views(self, g, keys=None):
        g1, g2 = views(self, g, keys)
        if g1.node_mask is None or g2.node_mask is None:
            mvgrl_masks.append((0, 0, False))  # no subsample ran
        else:
            mvgrl_masks.append((int(g1.node_mask.sum()),
                                int(g2.node_mask.sum()),
                                bool(torch.equal(g1.node_mask,
                                                 g2.node_mask))))
        return g1, g2

    def timed_augment(self, g, key):
        t = sync_s()
        out = augment(self, g, key)
        ppr_ms.append(1e3 * (sync_s() - t))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["RLAP_TPU_DATA"] = os.path.join(tmp, "no-datasets")
        base = dict(hidden_dim=128, num_layers=2, max_epochs=CLI_EPOCHS)
        K.reset_launch_counts()
        summary["grace"] = cli_run(ExperimentConfig(
            recipe="grace", dataset="PUBMED", augmentor="EdgeDroppingPR",
            **base), tmp)
        launches = dict(K.launch_counts)
        require(summary["grace"]["num_nodes"] == CLI_GRACE_N,
                f"PUBMED stand-in has {summary['grace']['num_nodes']} nodes")
        for name in K.KERNELS:
            require(launches[name] == 2 * CLI_EPOCHS,
                    f"{name} launched {launches[name]} times in the CLI's "
                    f"{CLI_EPOCHS} GRACE epochs")
        summary["grace"]["infonce_launches"] = launches

        MVGRLTrainer.views, PPRDiffusion.augment = (recording_views,
                                                    timed_augment)
        try:
            summary["mvgrl"] = cli_run(ExperimentConfig(
                recipe="mvgrl", dataset="PUBMED", augmentor="PPRDiffusion",
                **base), tmp, traced=True)
        finally:
            MVGRLTrainer.views, PPRDiffusion.augment = views, augment
        require(len(ppr_ms) == 1, f"PPR built {len(ppr_ms)} times")
        require(all(a >= SUBSAMPLE and b >= SUBSAMPLE and same
                    for a, b, same in mvgrl_masks),
                f"MVGRL subsample masks {mvgrl_masks}")
        summary["mvgrl"]["ppr_build_ms"] = ppr_ms[0]
        summary["mvgrl"]["subsample_kept"] = sorted(
            {a for a, _, _ in mvgrl_masks})
        summary["cca_ssg"] = cli_run(ExperimentConfig(
            recipe="cca_ssg", dataset="CORA", augmentor="rlap", **base), tmp)
        for recipe in ("graphcl", "bgrl"):
            summary[recipe] = cli_run(ExperimentConfig(
                recipe=recipe, dataset="MUTAG", augmentor="rLap",
                max_epochs=CLI_EPOCHS), tmp)
        summary["registry"] = registry_sweep()
        del os.environ["RLAP_TPU_DATA"]

    # the kernels at GRACE's shape in the CLI run (not counted above; the
    # kernel phase holds them against their plain versions at this shape)
    n, f = summary["grace"]["num_nodes"], 128
    a, b, _m, g = inputs(n, f, False, 11)
    _, lse = K.infonce_fwd_plain(a, b, 0.2)
    summary["infonce_at_cli_shape"] = {
        "n": n, "f": f,
        "infonce_fwd_ms": cuda_ms(lambda: K.infonce_fwd(a, b, 0.2), 5),
        "infonce_bwd_da_ms": cuda_ms(
            lambda: K.infonce_bwd_da(a, b, lse, g, 0.2), 5),
        "infonce_bwd_db_ms": cuda_ms(
            lambda: K.infonce_bwd_db(a, b, lse, g, 0.2), 5),
        **{f"{name}_bound_ms": bound(name, n, f)["bound_ms"]
           for name in K.KERNELS}}
    print(f"infonce at the CLI's shape: "
          f"{json.dumps(summary['infonce_at_cli_shape'])}", flush=True)
    return summary, launches


SHARDED_STEPS = 3
# world 1 over NCCL; world 2 on the one card over gloo, which takes CUDA
# tensors (NCCL refuses two ranks on one card: "Duplicate GPU detected")
SHARDED_WORLDS = ((1, "nccl"), (2, "gloo"))
SHARDED_TIMEOUT = 600


def all_edges(g, group) -> tuple:
    """The live edges of every rank's shard, on every rank."""
    m = g.edge_mask
    mine = torch.stack([g.senders[m], g.receivers[m],
                        g.weights[m].double().view(torch.int64)], 1)
    size = torch.distributed.get_world_size(group)
    counts = torch.zeros(size, dtype=torch.int64, device=mine.device)
    torch.distributed.all_gather_into_tensor(
        counts, torch.tensor([mine.shape[0]], device=mine.device),
        group=group)
    top = int(counts.max())
    pad = torch.zeros((top, 3), dtype=torch.int64, device=mine.device)
    pad[:mine.shape[0]] = mine
    out = torch.empty((size * top, 3), dtype=torch.int64, device=mine.device)
    torch.distributed.all_gather_into_tensor(out, pad, group=group)
    out = torch.cat([out[i * top:i * top + int(c)]
                     for i, c in enumerate(counts.tolist())])
    return out[:, 0], out[:, 1], out[:, 2].view(torch.float64)


def check_schur(s, r, w, n: int, t: int, removed: int, label: str) -> dict:
    """Exactly t nodes removed; the union of the shards, coalesced, is
    symmetric (each edge's mirror present with the same weight, rtol
    1e-6) with positive weights; at most n - t nodes keep an edge; no
    self-loop."""
    require(removed == t, f"{label}: removed {removed}, not {t}")
    key, inv = torch.unique(s * (n + 1) + r, return_inverse=True)
    wsum = torch.zeros(key.shape[0], dtype=torch.float64,
                       device=w.device).index_add_(0, inv, w.double())
    su, ru = key // (n + 1), key % (n + 1)
    mirror = torch.searchsorted(key, ru * (n + 1) + su).clamp_max(
        key.shape[0] - 1)
    require(bool((key[mirror] == ru * (n + 1) + su).all()),
            f"{label}: an edge without its mirror")
    require(bool(torch.isclose(wsum[mirror], wsum, rtol=1e-6, atol=0).all()),
            f"{label}: mirror weights differ")
    require(bool((wsum > 0).all()) and bool((su != ru).all()),
            f"{label}: a weight <= 0 or a self-loop")
    kept = int(torch.unique(su).shape[0])
    require(kept <= n - t, f"{label}: {kept} nodes keep edges, n - t = "
            f"{n - t}")
    return {"edges": int(key.shape[0]), "nodes_with_edges": kept}


def sharded_checks(rank: int, world: int, n: int, f: int) -> dict:
    """One rank of the sharded phase's checks, on the card, at BA(n, m=8)
    with f-wide features, partitioned by sender block over a 1-D mesh:

    * the sharded `spmm` against the local `spmm` on the encoder's inputs
      (self-loops, GCN-normalised weights from the global degrees), rtol
      1e-5, atol 1e-5, and both against float64. (With unit weights a
      hub's sum of thousands of terms carries float32 rounding past 1e-5
      in either, as `index_add_` adds in no fixed order);
    * 3 `GraceTrainer(mesh=...)` steps against the local trainer's on the
      same views (Compose([RLap(0.2), FeatureMasking(0.3)]) x 2, made on
      rank 0 and sent to every rank), losses within rtol 1e-4, atol 1e-5;
    * one sharded rLap view at t = 0.2 n and one call at t = n / 2, each
      started together on every rank and timed to the slowest, and checked
      by `check_schur` on the union of the shards."""
    dev = torch.device("cuda")
    mesh = make_mesh(device=dev)
    group = mesh.get_group("data")
    g = barabasi_albert(n, 8, seed=0, device=dev)
    g = g.replace(x=torch.as_tensor(DR.features(n, f), device=dev))
    gs = shard_graph(partition_edges_by_sender(g, world), mesh)
    res = {"rank": rank, "world": world}

    # the encoder's product: loops added, GCN-normalised weights (the
    # sharded degrees all-reduced); beside it, both against float64
    gl, wn = gcn_norm(gs, mesh=mesh)
    gl0, wn0 = gcn_norm(g)
    got, ref = spmm(gl, g.x, wn, mesh=mesh), spmm(gl0, g.x, wn0)
    res["spmm_max_abs_err"] = close(f"sharded spmm world {world}", got, ref,
                                    1e-5, 1e-5)
    ref64 = spmm(gl0, g.x.double(), wn0.double())
    res["spmm_vs_float64"] = {"sharded": float((got - ref64).abs().max()),
                              "local": float((ref - ref64).abs().max())}

    aug = Compose([RLap(FRAC, device=dev), FeatureMasking(0.3)])
    kw = dict(hidden_dim=128, num_layers=2, seed=0, device=dev)
    local = GraceTrainer(aug, aug, **kw)
    sharded = GraceTrainer(aug, aug, mesh=mesh, **kw)
    key = rng.key(7, device=dev)
    losses = {"local": [], "sharded": []}
    for i in range(SHARDED_STEPS):
        views = [broadcast_graph(aug(g, k) if rank == 0 else None, mesh, dev)
                 for k in rng.split(rng.fold_in(key, i))]
        losses["local"].append(local.train_step(*views))
        losses["sharded"].append(sharded.train_step(
            *(shard_graph(v, mesh) for v in views)))
    close(f"sharded GRACE losses world {world}",
          torch.tensor(losses["sharded"]), torch.tensor(losses["local"]),
          1e-4, 1e-5)
    res["grace_losses"] = losses

    for label, t in (("view", int(FRAC * n)), ("half", n // 2)):
        torch.distributed.barrier(group)
        t0 = sync_s()
        out, removed, overflow = eliminate_sharded(
            gs, rng.key(11, device=dev), t, mesh)
        ms = 1e3 * (sync_s() - t0)
        require(not overflow, f"{label}: overflow")
        res[f"rlap_{label}_ms"] = ms
        res[f"rlap_{label}_t"] = t
        res[f"rlap_{label}"] = check_schur(*all_edges(out, group), n, t,
                                           removed, f"rLap {label} world "
                                           f"{world}")
    res["directed_edges"] = int(g.num_edges)
    return res


def sharded_rank(rank: int, world: int, n: int, f: int) -> dict:
    """One rank of the sharded phase: the dry run's rank
    (`dryrun.rank_main`, what `dryrun_multichip` runs in each rank it
    spawns), then `sharded_checks`, in one process each."""
    return {"dryrun": DR.rank_main(rank, world, n, f, SHARDED_STEPS, "cuda"),
            "checks": sharded_checks(rank, world, n, f)}


def sharded_phase(n: int, f: int, single_eps: float) -> tuple:
    """The sharded layer on the card, at each of `SHARDED_WORLDS`, in
    spawned ranks (`launch`): the dry run (the distributed rLap at
    n=4096, then 3 GRACE steps through `eliminate_sharded` views at
    BA(n, m=8), f), whose ranks report their InfoNCE launches, set to 0
    just before the steps and read just after (each kernel twice a step
    on every rank), and whose losses and parameters must be equal on every
    rank (`dryrun.summarise`); then the checks of `sharded_checks`. Prints
    each rank's step, views and rLap ms a view, and edges/s of the t = n/2
    call beside the single-device `eliminate`'s (`single_eps`, from the
    bench phase). Returns (the phase's summary, InfoNCE launches by
    world)."""
    summary, launches = {}, {}
    for world, backend in SHARDED_WORLDS:
        label = f"world{world}_{backend}"
        t = time.perf_counter()
        ranks = launch(sharded_rank, world, args=(n, f), backend=backend,
                       timeout=SHARDED_TIMEOUT)
        wall_s = time.perf_counter() - t
        dry = DR.summarise([r["dryrun"] for r in ranks], backend)
        checks = [r["checks"] for r in ranks]
        counts = {name: 0 for name in K.KERNELS}
        for rk in dry["ranks"]:
            for name in K.KERNELS:
                require(rk["infonce_launches"][name] == 2 * SHARDED_STEPS,
                        f"{label} rank {rk['rank']}: {name} launched "
                        f"{rk['infonce_launches'][name]} times in "
                        f"{SHARDED_STEPS} steps")
                counts[name] += rk["infonce_launches"][name]
            print(f"sharded dryrun {label} rank {rk['rank']}: step ms "
                  f"{rk['step_ms']}, views ms {rk['views_ms']}, rLap ms a "
                  f"view {rk['rlap_ms_per_view']}, rLap at n="
                  f"{rk['rlap_n']} {rk['rlap_ms']} ms, losses "
                  f"{rk['losses']}", flush=True)
        launches[label] = counts
        edges = checks[0]["directed_edges"]
        half_ms = max(c["rlap_half_ms"] for c in checks)
        eps = edges / (half_ms / 1e3)
        for c in checks:
            print(f"sharded checks {label} rank {c['rank']}: spmm max abs "
                  f"err {c['spmm_max_abs_err']} (against float64 "
                  f"{json.dumps(c['spmm_vs_float64'])}), GRACE losses "
                  f"{json.dumps(c['grace_losses'])}, rLap view (t="
                  f"{c['rlap_view_t']}) {c['rlap_view_ms']} ms, t=n/2 "
                  f"{c['rlap_half_ms']} ms", flush=True)
        print(f"eliminate_sharded {label}: {eps} edges/s at t=n/2; the "
              f"single-device eliminate {single_eps} edges/s", flush=True)
        summary[label] = {
            "world": world, "backend": backend, "dryrun": dry,
            "checks": checks, "edges_per_s": eps,
            "single_device_edges_per_s": single_eps, "wall_s": wall_s}
    return summary, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000,
                    help="nodes of the main path's BA graph")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} float32 matmul precision="
          f"{torch.get_float32_matmul_precision()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(mod.build, ("-Xptxas", "-v"))
                  for mod in (K, A)]
        built = [b.result() for b in builds]
    print(f"built {', '.join(lib.name for lib, _ in built)} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for _lib, log in built:
        for line in log.splitlines():
            if ("Used" in line or "Compiling entry" in line
                    or "spill" in line or "C75" in line):
                print(f"  ptxas: {line.strip()}")
    for kname, usage in ptxas_usage(built[1][1], (
            "take_two_level_cluster_kernel",
            "take_scalar_cluster_kernel", "fill_trigger_kernel",
            "scatter_min_merged_kernel", "take2d_kernel",
            "take_axis0_slab_kernel",
            "take_axis0_axis1_shuffle_kernel")).items():
        print(f"  ptxas, redesigned C2 / C3 / C4 / V1 / V2 / V4: "
              f"{kname}: "
              f"{usage}", flush=True)
    plan = A.scalar_plan(PROBE_N, P.TILE)
    print(f"  dynamic shared memory of take_scalar_cluster_kernel at "
          f"n={PROBE_N}: {plan.smem} bytes a block, a cluster of "
          f"{plan.blocks}", flush=True)
    nt = -(-PROBE_N // A.LANES) * A.LANES
    print(f"  dynamic shared memory of take_two_level_cluster_kernel and "
          f"take_axis0_axis1_shuffle_kernel at n={PROBE_N}, by cluster "
          f"size: " + ", ".join(f"k={k} {A.table_plan(nt, k).smem} bytes "
                                f"a block" for k in P.SWEEP), flush=True)
    print(f"  dynamic shared memory of take_axis0_slab_kernel at n={PROBE_N}, "
          f"by slab width: " + ", ".join(
              f"{c} columns {A.slab_plan(nt, c).smem} bytes a block"
              for c in P.SLAB_SWEEP), flush=True)
    print("  dynamic shared memory a block at f <= 128: infonce_fwd (wgmma) "
          "197632 bytes (4 stages and 2 lo planes of 64 x 128 floats), "
          "infonce_bwd_da and infonce_bwd_db (wgmma) 230400 bytes each (64 "
          "resident rows and their lo plane, 4 stages, 2 lo planes and 2 "
          "pairs of transposed planes of 32 x 128 floats); the mma.sync "
          "kernels of other widths 168960 bytes (128 resident rows and 3 "
          "stages of 64 rows, 132 floats each)", flush=True)
    sass = _build.sass_counts(built[0][0], ("HGMMA", "WARPGROUP.DEPBAR"))
    for name, counts in sass.items():
        if counts["HGMMA"]:
            print(f"  sass: {name} {json.dumps(counts)}", flush=True)

    f = 128
    rows = kernel_phase(args.n, f)
    check_step_against_float64(f)
    g = make_graph(args.n, f)
    probe, probe_launches = probe_phase(g)
    print(json.dumps({"probe_access": probe}), flush=True)
    check_default_device()
    summary, launches = main_path(g, f)
    print(json.dumps({"main_path": summary}), flush=True)
    del g
    torch.cuda.empty_cache()
    t = time.perf_counter()
    bench_launches, single_eps = bench_phase(args.n, smi)
    print(f"bench phase: {time.perf_counter() - t:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cli, cli_launches = cli_phase()
    cli["phase_s"] = time.perf_counter() - t
    print(json.dumps({"cli": cli}), flush=True)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    sharded, sharded_launches = sharded_phase(args.n, f, single_eps)
    sharded["phase_s"] = time.perf_counter() - t
    print(json.dumps({"sharded": sharded}), flush=True)

    kernels = [{"name": name, "route": "cuda",
                "source": "rlap_tpu_torch/csrc/infonce.cu",
                "replaces": REPLACES[name], "launches": launches[name],
                "launches_by_path": {
                    "grace_main_path": launches[name],
                    "epoch_bench_separate": bench_launches["separate"][name],
                    "epoch_bench_paired": bench_launches["paired"][name],
                    "cli_grace_pubmed": cli_launches[name],
                    **{f"sharded_dryrun_{label}": counts[name]
                       for label, counts in sharded_launches.items()}},
                "n": args.n, "f": f, "card": smi, **rows[name]}
               for name in K.KERNELS]
    for name in A.NAMES:
        row = {**probe["kernels"], **probe["previous"]}[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "rlap_tpu_torch/csrc/access.cu",
            "replaces": REPLACES[name], "launches": probe_launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["yardstick_ms"],
            "previous_design": name in A.PREVIOUS, "card": smi,
            "shape": {"table": probe["n"], "indices": row["elements"]}})
        if name == "take_axis0":
            kernels[-1].update(
                plan=row["plan"], stage_cycles=row["stage_cycles"],
                lookup_cycles=row["lookup_cycles"], blocks=row["blocks"],
                ms_by_plan={k: r["ms"] for k, r in probe["by_slab"].items()})
        if name == "take2d":
            kernels[-1].update(load_cycles=row["load_cycles"],
                               select_cycles=row["select_cycles"],
                               blocks=row["blocks"])
        if name in ("take", "take2d"):
            kernels[-1]["rlap_stream_ms"] = \
                probe["rlap_select_stream"][f"{name}_ms"]
        if name in ("take_two_level", "take_axis0_axis1"):
            kernels[-1].update(
                plan=row["plan"], stage_share=row["stage_share"],
                clusters=row["clusters"],
                lookup_reads_per_s=row["lookup_reads_per_s"],
                ms_by_cluster={k: r["ms"] for k, r in
                               probe["by_cluster"][name].items()})
        if name in P.RATED:
            kernels[-1]["read_rate"] = probe["read_rates"][name]
        if name == "take_scalar":
            # the one-thread walk's own floor, from its cycles in this run
            kernels[-1]["walk_floor_ms"] = \
                probe["take_scalar_cycles"]["random"]["walk_ms"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
