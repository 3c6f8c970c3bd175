"""The port's binding of the C++ oracle (`rlap_tpu_torch.native`) against
the JAX package's (`rlap_tpu.native`): the same source, byte for byte,
built with the same flags, gives equal arrays for one input and seed. The
port builds it under `build/native/` at the repository root and writes
nothing inside its package."""

from pathlib import Path

import numpy as np
import pytest
import torch

import rlap_tpu.native as JN
import rlap_tpu_torch.native as N
from rlap_tpu.data.synthetic import barabasi_albert as jax_ba
from rlap_tpu_torch.data.synthetic import barabasi_albert

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of a thread per core in each of them makes every
    small op wait on threads that are not scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_source_is_the_jax_packages_byte_for_byte():
    assert N.SRC.read_bytes() == (ROOT / "rlap_tpu/native/oracle.cc"
                                  ).read_bytes()
    assert N.SRC.parent == ROOT / "rlap_tpu_torch" / "native"


@pytest.mark.parametrize("o_v,o_n,seed", [("random", "random", 0),
                                          ("degree", "asc", 1),
                                          ("coarsen", "random", 2)])
def test_oracle_equal_to_the_jax_packages(o_v, o_n, seed):
    g = barabasi_albert(200, 3, seed=0, device="cpu")
    ei, w = N.live_edges(g)
    w = w * np.linspace(0.5, 2.0, w.shape[0])  # weights that are not all 1
    got = N.oracle_approximate_cholesky(ei, w, 200, 100, o_v=o_v, o_n=o_n,
                                        seed=seed)
    want = JN.oracle_approximate_cholesky(ei, w, 200, 100, o_v=o_v,
                                          o_n=o_n, seed=seed)
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # unit weights when none are given, as in the JAX binding
    np.testing.assert_array_equal(
        N.oracle_approximate_cholesky(ei, None, 200, 50, seed=seed)[1],
        JN.oracle_approximate_cholesky(ei, None, 200, 50, seed=seed)[1])


def test_live_edges_are_the_graphs_own():
    g = barabasi_albert(60, 2, seed=4, device="cpu")
    jg = jax_ba(60, 2, seed=4)
    m = np.asarray(jg.edge_mask)
    ei, w = N.live_edges(g)
    np.testing.assert_array_equal(ei, np.stack([np.asarray(jg.senders)[m],
                                                np.asarray(jg.receivers)[m]]))
    np.testing.assert_array_equal(w, np.asarray(jg.weights)[m])
    assert ei.dtype == np.int64 and w.dtype == np.float64


def test_identity_copies_through_the_library():
    a = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    out = N.oracle_identity(a)
    assert out.dtype == np.float64 and out.shape == (3, 4)
    np.testing.assert_array_equal(out, a.astype(np.float64))
    np.testing.assert_array_equal(out, JN.oracle_identity(a))


def test_read_tsv_round_trip(tmp_path):
    rows = [(1, 2, 0.5), (2, 1, 0.5), (3, 1, 2.25), (1, 3, 2.25)]
    path = tmp_path / "edges.tsv"
    path.write_text("".join(f"{i}\t{j}\t{v}\n" for i, j, v in rows))
    ei, w = N.read_tsv(str(path))
    np.testing.assert_array_equal(ei, [[0, 1, 2, 0], [1, 0, 0, 2]])
    np.testing.assert_array_equal(w, [0.5, 0.5, 2.25, 2.25])
    jei, jw = JN.read_tsv(str(path))
    np.testing.assert_array_equal(ei, jei)
    np.testing.assert_array_equal(w, jw)
    with pytest.raises(RuntimeError):
        N.read_tsv(str(tmp_path / "missing.tsv"))


def test_rejects_bad_input():
    ei = np.array([[0, 1], [1, 0]])
    with pytest.raises(ValueError):
        N.oracle_approximate_cholesky(ei, None, 2, 1, o_v="x")
    with pytest.raises(ValueError):
        N.oracle_approximate_cholesky(ei[0], None, 2, 1)
    with pytest.raises(ValueError):
        N.oracle_approximate_cholesky(ei, np.ones(3), 2, 1)
    with pytest.raises(RuntimeError):  # an index past num_nodes
        N.oracle_approximate_cholesky(ei + 5, None, 2, 1)


def test_library_lands_in_build_and_not_in_the_package():
    N.oracle_identity(np.zeros(1))
    lib = N.library_path()
    assert lib.exists() and lib.parent == ROOT / "build" / "native"
    assert lib.name.startswith("librlap_native_") and lib.suffix == ".so"
    pkg = ROOT / "rlap_tpu_torch"
    assert not [p for p in pkg.rglob("*") if p.suffix in (".so", ".o")]
    assert sorted(p.name for p in (pkg / "native").iterdir()
                  if p.name != "__pycache__") == ["__init__.py", "oracle.cc"]
