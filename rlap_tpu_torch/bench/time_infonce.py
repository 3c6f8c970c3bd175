"""Check and time the three InfoNCE kernels on the card:

    python -m rlap_tpu_torch.bench.time_infonce [n ...] [--f F] [--tau TAU]

For each n (default 20000 100000) it holds every kernel against its plain
version on unit rows made from a seed (values rtol 1e-5 / atol 1e-5,
gradients rtol 1e-4 / atol 1e-6), then times each with CUDA events (one
warm-up, three launches), and prints one JSON line. It is the quick loop
for work on `rlap_tpu_torch/csrc/infonce.cu`; `chip_smoke.py` is the full
check."""

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
    return row


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
