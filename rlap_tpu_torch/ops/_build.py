"""Build and load the package's CUDA sources.

One shared library per `.cu` file of `rlap_tpu_torch/csrc/`, compiled with
`nvcc` for `sm_90a` at first use into `build/kernels/` at the repository
root, named by a hash of that source and the flags, and loaded with
ctypes. The sources have a plain C interface (device pointers, sizes and
the stream), so a build takes seconds. There is no fallback: a build that
fails raises, and so does a launch whose launcher returns a CUDA error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def source_path(stem: str) -> Path:
    return CSRC_DIR / f"{stem}.cu"


def library_path(stem: str) -> Path:
    """`build/kernels/lib<stem>_<hash of the source and the flags>.so`."""
    digest = hashlib.sha256(source_path(stem).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}_{digest}.so"


def build(stem: str, extra_flags: Tuple[str, ...] = ()) -> Tuple[Path, str]:
    """Compile `csrc/<stem>.cu` unless a library of this source exists (with
    `extra_flags` it is always compiled, so that the compiler's output can
    be read). Returns (library path, compiler output)."""
    lib = library_path(stem)
    if lib.exists() and not extra_flags:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           str(source_path(stem))]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib, res.stdout + res.stderr


def load(stem: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of `csrc/<stem>.cu`, built if need be. `declare`
    sets the argtypes and restype of its functions, once."""
    if stem not in _libs:
        lib = ctypes.CDLL(str(build(stem)[0]))
        declare(lib)
        _libs[stem] = lib
    return _libs[stem]


def sass_counts(lib: Path,
                needles: Tuple[str, ...]) -> Dict[str, Dict[str, int]]:
    """How often each of `needles` occurs in each kernel's machine code
    (`cuobjdump -sass` of a built library), by mangled kernel name: for
    instance `WARPGROUP.DEPBAR`, the full waits that ptxas puts behind
    `wgmma` when it cannot keep them asynchronous."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts: Dict[str, Dict[str, int]] = {}
    name = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {k: 0 for k in needles}
        elif name is not None:
            for k in needles:
                counts[name][k] += line.count(k)
    return counts


def on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs its
    plain version), False when all lie on one CUDA device (it launches the
    kernel). Anything else raises: a wrapper never falls back."""
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"tensors must all be on one CUDA device or the "
                         f"CPU, got {[str(t.device) for t in ts]}")
    return False


def launch(stem: str, declare: Callable[[ctypes.CDLL], None], name: str,
           tensors, *scalars) -> None:
    """Call launcher `name` of `csrc/<stem>.cu` with the tensors' device
    pointers, then `scalars`, then PyTorch's current stream of the tensors'
    device. Raises if the launcher returns a CUDA error."""
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(load(stem, declare), name)(
            *(t.data_ptr() for t in tensors), *scalars, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
