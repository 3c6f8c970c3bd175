"""ctypes binding of the sequential C++ rLap oracle.

Counterpart of `rlap_tpu/native/__init__.py`, with its own copy of the
source (`oracle.cc`, byte for byte the JAX package's), so that the port's
benches reach the oracle on a machine without JAX. At first use `g++`
compiles it into `build/native/librlap_native_<hash>.so` at the repository
root, named by a hash of the source and the flags; a failed build raises
with the compiler's message. Nothing is written inside the package.

The oracle works on host numpy arrays: `live_edges` takes a graph's live
edges off its device first. Same functions, signatures and results as the
JAX package's binding: for one input and seed the outputs are equal.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "oracle.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
             "-fvisibility=hidden")

_O_V = {"random": 0, "degree": 1, "coarsen": 2}
_O_N = {"asc": 0, "desc": 1, "random": 2}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """`build/native/librlap_native_<hash of the source and flags>.so`."""
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"librlap_native_{digest}.so"


def build() -> Path:
    """Compile the oracle unless this source's library exists. Several
    processes may build at once: each writes its own file and renames it
    into place."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    res = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}) on {SRC}:\n"
                           f"{res.stderr}")
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.rlap_approximate_cholesky.restype = ctypes.c_int64
        lib.rlap_approximate_cholesky.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rlap_identity.restype = None
        lib.rlap_identity.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.rlap_read_tsv.restype = ctypes.c_int64
        lib.rlap_read_tsv.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ]
        _lib = lib
        return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def live_edges(g) -> Tuple[np.ndarray, np.ndarray]:
    """A graph's live edges on the host: (edge_index int64 [2, E], weights
    float64 [E]), both directions as the graph holds them."""
    m = g.edge_mask
    ei = np.stack([g.senders[m].cpu().numpy(), g.receivers[m].cpu().numpy()])
    return ei.astype(np.int64), g.weights[m].cpu().numpy().astype(np.float64)


def oracle_approximate_cholesky(
    edge_index: np.ndarray,
    edge_weights: Optional[np.ndarray],
    num_nodes: int,
    num_remove: int,
    o_v: str = "random",
    o_n: str = "random",
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sequential Schur complement of the symmetric edge list `edge_index`
    [2, E] (unit weights when `edge_weights` is None) after removing
    `num_remove` nodes. Returns (edge_index int64 [2, E'], weights [E']),
    both directions present."""
    if o_v not in _O_V or o_n not in _O_N:
        raise ValueError(f"o_v must be one of {tuple(_O_V)} and o_n one of "
                         f"{tuple(_O_N)}, got {o_v!r}, {o_n!r}")
    edge_index = np.asarray(edge_index, np.float64)
    if edge_index.ndim != 2 or edge_index.shape[0] != 2:
        raise ValueError(f"edge_index must be [2, E], got {edge_index.shape}")
    e = edge_index.shape[1]
    if edge_weights is None:
        edge_weights = np.ones((e,), np.float64)
    edge_weights = np.asarray(edge_weights, np.float64)
    if edge_weights.shape != (e,):
        raise ValueError(f"edge_weights must be [{e}], got "
                         f"{edge_weights.shape}")
    lib = _load()
    info = np.ascontiguousarray(
        np.concatenate([edge_index, edge_weights[None]], axis=0).T)
    out_cap = max(4 * e + 16, 64)
    out = np.empty((out_cap, 3), np.float64)
    cnt = ctypes.c_int64(0)
    rc = lib.rlap_approximate_cholesky(
        _dptr(info), e, int(num_nodes), int(num_remove), _O_V[o_v],
        _O_N[o_n], int(seed), _dptr(out), out_cap, ctypes.byref(cnt))
    if rc < 0:
        raise RuntimeError(f"oracle failed with code {rc}")
    res = out[: cnt.value]
    return res[:, :2].T.astype(np.int64), res[:, 2].copy()


def oracle_identity(a: np.ndarray) -> np.ndarray:
    """A copy of `a` as float64, made by the library (a marshalling check)."""
    lib = _load()
    a = np.ascontiguousarray(a, np.float64)
    out = np.empty_like(a)
    lib.rlap_identity(_dptr(a), a.size, _dptr(out))
    return out


def read_tsv(path: str, cap: int = 1 << 22) -> Tuple[np.ndarray, np.ndarray]:
    """1-indexed (i, j, v) text file -> (edge_index [2, E], weights [E])."""
    lib = _load()
    out = np.empty((cap, 3), np.float64)
    cnt = lib.rlap_read_tsv(str(path).encode(), _dptr(out), cap)
    if cnt < 0:
        raise RuntimeError(f"read_tsv failed with code {cnt}")
    res = out[:cnt]
    return res[:, :2].T.astype(np.int64), res[:, 2].copy()
