"""Check and time the InfoNCE kernels on the card:

    python -m rlap_tpu_torch.bench.time_infonce [n ...] [--f F] [--tau TAU]

For each n (default 20000 100000) it holds every kernel against its plain
version on unit rows made from a seed (values rtol 1e-5 / atol 1e-5,
gradients rtol 1e-4 / atol 1e-6), then times each with CUDA events (one
warm-up, three launches), and prints one JSON line. Where the width takes
the pair kernels (`takes_pair`), the line also holds the pair forward and
one pair gradient launch, and both directions of the dual-branch loss
each way: `pair_ms` (one forward, two gradients) beside `one_way_ms` (two
forwards, two dA, two dB). It is the quick loop for work on
`rlap_tpu_torch/csrc/infonce.cu`; `chip_smoke.py` is the full check."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from rlap_tpu_torch.ops import infonce_fused as K


def cuda_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(n: int, f: int, tau: float) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(n)
    a, b = (K.l2norm(torch.randn(n, f, generator=gen,
                                 device="cuda")).contiguous()
            for _ in range(2))
    g = torch.full((n,), -1.0 / n, device="cuda")
    out, lse = K.infonce_fwd(a, b, tau)
    out_p, lse_p = K.infonce_fwd_plain(a, b, tau)
    torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)
    row = {"n": n, "f": f, "tau": tau}
    for name, kern, plain in (
            ("infonce_bwd_da", K.infonce_bwd_da, K.infonce_bwd_da_plain),
            ("infonce_bwd_db", K.infonce_bwd_db, K.infonce_bwd_db_plain)):
        torch.testing.assert_close(kern(a, b, lse_p, g, tau),
                                   plain(a, b, lse_p, g, tau),
                                   rtol=1e-4, atol=1e-6)
        row[name + "_ms"] = cuda_ms(lambda: kern(a, b, lse_p, g, tau))
    row["infonce_fwd_ms"] = cuda_ms(lambda: K.infonce_fwd(a, b, tau))
    if K.takes_pair(a, b):
        row.update(time_pair(a, b, g, tau))
        row["one_way_ms"] = 2 * sum(row[k + "_ms"] for k in K.KERNELS)
    return row


def time_pair(a, b, g, tau: float) -> dict:
    """The pair kernels against their plain versions, then timed: the
    forward, one gradient launch and a loss's three launches."""
    got = K.infonce_fwd_pair(a, b, tau)
    plain = K.infonce_fwd_pair_plain(a, b, tau)
    for x, p in zip(got, plain):
        torch.testing.assert_close(x, p, rtol=1e-5, atol=1e-5)
    _o1, lse1, _o2, lse2 = plain
    g2 = torch.roll(g, 1)
    for p, q, own, rest in ((a, b, (lse1, g), (lse2, g2)),
                            (b, a, (lse2, g2), (lse1, g))):
        torch.testing.assert_close(
            K.infonce_bwd_pair(p, q, *own, *rest, tau),
            K.infonce_bwd_pair_plain(p, q, *own, *rest, tau),
            rtol=1e-4, atol=1e-6)
    del got, plain

    def loss():
        K.infonce_fwd_pair(a, b, tau)
        K.infonce_bwd_pair(a, b, lse1, g, lse2, g2, tau)
        K.infonce_bwd_pair(b, a, lse2, g2, lse1, g, tau)

    return {"infonce_fwd_pair_ms": cuda_ms(
                lambda: K.infonce_fwd_pair(a, b, tau)),
            "infonce_bwd_pair_ms": cuda_ms(
                lambda: K.infonce_bwd_pair(a, b, lse1, g, lse2, g2, tau)),
            "pair_ms": cuda_ms(loss)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="*", default=[20000, 100000])
    ap.add_argument("--f", type=int, default=128)
    ap.add_argument("--tau", type=float, default=0.2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_infonce: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    for n in args.n:
        print(json.dumps(run(n, args.f, args.tau)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
