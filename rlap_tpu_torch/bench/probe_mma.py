"""Build and run `rlap_tpu_torch/bench/probe_mma.cu` on the card:

    python -m rlap_tpu_torch.bench.probe_mma

It measures what bounds a 3xTF32 kernel built on `mma.sync` on this card:
the `mma.sync` TF32 rate, and whether shared-memory loads and the float32
operations of an operand split overlap with it. One JSON line per loop;
the source says what each loop does. A measurement tool with no plain
version: it computes nothing that the port uses."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from rlap_tpu_torch.ops import _build


def main() -> int:
    exe = _build.BUILD_DIR / "probe_mma"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-o", str(exe),
                    str(Path(__file__).with_suffix(".cu"))], check=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return subprocess.run([str(exe)]).returncode


if __name__ == "__main__":
    sys.exit(main())
