"""Dataset loaders: Planetoid, GNN-benchmark npz and TU formats, and the
dataset registry with its synthetic stand-ins (counterpart of
`rlap_tpu/data/loaders.py`).

The parsing is numpy, line for line the JAX package's, so both packages
read the same files into equal arrays; only the final `Graph`s are built
on `device` (the card by default). Nothing is downloaded: when a
dataset's files are absent under `root` (default `$RLAP_TPU_DATA`, else
`~/datasets`), `load_dataset` and `load_graph_dataset` return a
deterministic synthetic stand-in of comparable shape, flagged by
`meta["synthetic"]`.
"""

from __future__ import annotations

import os
import pickle
import warnings
from pathlib import Path
from typing import List, Optional

import numpy as np

from rlap_tpu_torch import resolve_device
from rlap_tpu_torch.core.graph import Graph


def normalize_features(x: np.ndarray) -> np.ndarray:
    """Row-sum normalisation (PyG NormalizeFeatures)."""
    s = np.abs(x).sum(axis=1, keepdims=True)
    return x / np.maximum(s, 1e-12)


def _symmetrize(s, r):
    pairs = np.unique(np.concatenate(
        [np.stack([s, r], 1), np.stack([r, s], 1)], 0), axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    return pairs[:, 0], pairs[:, 1]


def load_planetoid(root: str, name: str, device=None):
    """The Planetoid files `ind.<name>.{x,tx,allx,y,ty,ally,graph,
    test.index}` under `root`. Returns (Graph with .x row-normalised,
    labels int32, split masks)."""
    name = name.lower()
    d = Path(root)
    objs = {}
    for suf in ("x", "tx", "allx", "y", "ty", "ally", "graph"):
        with open(d / f"ind.{name}.{suf}", "rb") as f:
            objs[suf] = pickle.load(f, encoding="latin1")
    test_idx = np.loadtxt(d / f"ind.{name}.test.index", dtype=np.int64)
    test_sorted = np.sort(test_idx)

    allx = objs["allx"].toarray()
    tx = objs["tx"].toarray()
    ally, ty = objs["ally"], objs["ty"]
    n = int(max(test_idx.max() + 1, allx.shape[0] + tx.shape[0]))
    x = np.zeros((n, allx.shape[1]), np.float32)
    x[: allx.shape[0]] = allx
    x[test_sorted] = tx  # citeseer has gaps; zeros stay for isolated ids
    y = np.zeros((n,), np.int64)
    y[: ally.shape[0]] = ally.argmax(1)
    y[test_sorted] = ty.argmax(1)

    src, dst = [], []
    for u, nbrs in objs["graph"].items():
        for v in nbrs:
            src.append(u)
            dst.append(v)
    s, r = _symmetrize(np.asarray(src), np.asarray(dst))

    train_mask = np.zeros((n,), bool)
    val_mask = np.zeros((n,), bool)
    test_mask = np.zeros((n,), bool)
    train_mask[: objs["y"].shape[0]] = True
    val_mask[objs["y"].shape[0]: objs["y"].shape[0] + 500] = True
    test_mask[test_sorted] = True

    g = Graph.from_edges(s, r, num_nodes=n, x=normalize_features(x),
                         device=device)
    return g, y.astype(np.int32), {"train": train_mask, "valid": val_mask,
                                   "test": test_mask}


def load_npz_graph(path: str, device=None):
    """A GNN-benchmark npz (Coauthor, Amazon). Returns (Graph, labels)."""
    import scipy.sparse as sp

    with np.load(path, allow_pickle=True) as f:
        d = dict(f)
    adj = sp.csr_matrix((d["adj_data"], d["adj_indices"], d["adj_indptr"]),
                        shape=d["adj_shape"])
    if "attr_data" in d:
        x = sp.csr_matrix((d["attr_data"], d["attr_indices"],
                           d["attr_indptr"]), shape=d["attr_shape"]).toarray()
    else:
        x = d["attr_matrix"]
    coo = adj.tocoo()
    s, r = _symmetrize(coo.row.astype(np.int64), coo.col.astype(np.int64))
    g = Graph.from_edges(s, r, num_nodes=adj.shape[0],
                         x=normalize_features(x.astype(np.float32)),
                         device=device)
    return g, d["labels"].astype(np.int32)


def load_tu(root: str, name: str, feature_dim_fallback: int = 1,
            device=None):
    """The TU files `<root>/<name>/<name>_{A,graph_indicator,
    graph_labels}.txt` (node labels and attributes when present). Returns
    (list of Graph, labels int32); featureless graphs get x = ones of
    width `feature_dim_fallback`."""
    pre = Path(root) / name
    a = np.loadtxt(pre / f"{name}_A.txt", delimiter=",", dtype=np.int64)
    gi = np.loadtxt(pre / f"{name}_graph_indicator.txt", dtype=np.int64)
    gl = np.loadtxt(pre / f"{name}_graph_labels.txt", dtype=np.int64)
    node_labels = None
    nl_path = pre / f"{name}_node_labels.txt"
    if nl_path.exists():
        node_labels = np.loadtxt(nl_path, delimiter=",", dtype=np.int64)
        if node_labels.ndim > 1:
            node_labels = node_labels[:, 0]
    node_attrs = None
    na_path = pre / f"{name}_node_attributes.txt"
    if na_path.exists():
        node_attrs = np.loadtxt(na_path, delimiter=",", dtype=np.float32)
        if node_attrs.ndim == 1:
            node_attrs = node_attrs[:, None]

    # relabel to 0-based per-graph nodes
    gi0 = gi - gi.min()
    num_graphs = int(gi0.max()) + 1
    first = np.full(num_graphs, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first, gi0, np.arange(gi0.shape[0]))
    counts = np.bincount(gi0, minlength=num_graphs)

    s_all = a[:, 0] - 1  # TU files are 1-indexed
    r_all = a[:, 1] - 1
    owner = gi0[s_all]
    y = np.searchsorted(np.unique(gl), gl).astype(np.int32)

    if node_labels is not None:
        feats = np.eye(int(node_labels.max()) + 1,
                       dtype=np.float32)[node_labels]
        if node_attrs is not None:
            feats = np.concatenate([node_attrs, feats], axis=1)
    elif node_attrs is not None:
        feats = node_attrs
    else:
        feats = np.ones((gi0.shape[0], feature_dim_fallback), np.float32)

    dev = resolve_device(device)
    graphs: List[Graph] = []
    for gid in range(num_graphs):
        sel = owner == gid
        off = first[gid]
        n = int(counts[gid])
        graphs.append(Graph.from_edges(s_all[sel] - off, r_all[sel] - off,
                                       num_nodes=n, x=feats[off:off + n],
                                       device=dev))
    return graphs, y


NODE_DATASETS = ("CORA", "CITESEER", "PUBMED", "COAUTHOR-CS", "COAUTHOR-PHY",
                 "AMAZON-PHOTO", "AMAZON-COMPUTERS")
GRAPH_DATASETS = ("PROTEINS_full", "MUTAG", "IMDB-BINARY", "IMDB-MULTI",
                  "NCI1", "REDDIT-BINARY", "COLLAB", "PTC_MR")

_SYN_SHAPES = {  # (n, classes, feature_dim) of the synthetic stand-ins
    "CORA": (2708, 7, 1433), "CITESEER": (3327, 6, 3703),
    "PUBMED": (19717, 3, 500), "COAUTHOR-CS": (18333, 15, 6805),
    "COAUTHOR-PHY": (34493, 5, 8415), "AMAZON-PHOTO": (7650, 8, 745),
    "AMAZON-COMPUTERS": (13752, 10, 767),
}
# (graphs, fewest nodes, most nodes) of the TU stand-ins
_SYN_GRAPH_SHAPES = {"MUTAG": (188, 10, 28), "PROTEINS_full": (512, 10, 48),
                     "IMDB-BINARY": (256, 12, 40), "IMDB-MULTI": (256, 8, 30),
                     "NCI1": (512, 10, 40)}


def default_root() -> str:
    return os.environ.get("RLAP_TPU_DATA",
                          os.path.expanduser("~/datasets"))


def load_dataset(name: str, root: Optional[str] = None,
                 synthetic_scale: float = 1.0, device=None):
    """Node dataset by registry name. Returns (Graph, labels, meta), meta
    = {"synthetic": bool, "splits": mask dict or None}.

    The stand-in is an SBM at the dataset's node and class counts, its
    feature width capped at 512, p_in = 20/n, p_out = 2/n, feature noise
    10.0 and seed 42: on it the raw-feature probe is weak and a recipe
    scores well only by using the graph's homophily."""
    root = root or default_root()
    name = name.upper()
    try:
        if name in ("CORA", "CITESEER", "PUBMED"):
            sub = {"CORA": "Cora", "CITESEER": "CiteSeer",
                   "PUBMED": "PubMed"}[name]
            for cand in (Path(root) / sub / "raw", Path(root) / sub,
                         Path(root)):
                if (cand / f"ind.{sub.lower()}.graph").exists():
                    g, y, splits = load_planetoid(str(cand), sub,
                                                  device=device)
                    return g, y, {"synthetic": False, "splits": splits}
            raise FileNotFoundError(name)
        npz_names = {"COAUTHOR-CS": "ms_academic_cs.npz",
                     "COAUTHOR-PHY": "ms_academic_phy.npz",
                     "AMAZON-PHOTO": "amazon_electronics_photo.npz",
                     "AMAZON-COMPUTERS": "amazon_electronics_computers.npz"}
        if name in npz_names:
            for cand in (Path(root) / npz_names[name],
                         Path(root) / name / npz_names[name]):
                if cand.exists():
                    g, y = load_npz_graph(str(cand), device=device)
                    return g, y, {"synthetic": False, "splits": None}
            raise FileNotFoundError(name)
        raise KeyError(f"unknown node dataset {name}")
    except FileNotFoundError:
        from rlap_tpu_torch.data.synthetic import synthetic_node_dataset

        n, c, f = _SYN_SHAPES.get(name, (2048, 4, 256))
        n = max(int(n * synthetic_scale), 64)
        f = min(f, 512)
        warnings.warn(
            f"{name}: raw files not found under {root}; using a synthetic "
            f"SBM stand-in (n={n}, classes={c}, f={f})")
        g, y = synthetic_node_dataset(n=n, num_classes=c, feature_dim=f,
                                      p_in=min(20.0 / n, 1.0),
                                      p_out=min(2.0 / n, 1.0), noise=10.0,
                                      seed=42, device=device)
        return g, y, {"synthetic": True, "splits": None}


def load_graph_dataset(name: str, root: Optional[str] = None, device=None):
    """TU dataset by name. Returns (graphs, labels, meta). Absent files
    give an ER stand-in (seed 7): the shapes of `_SYN_GRAPH_SHAPES`, or
    128 graphs for other names."""
    root = root or default_root()
    try:
        if (Path(root) / name / f"{name}_A.txt").exists():
            graphs, y = load_tu(root, name, device=device)
            return graphs, y, {"synthetic": False}
        if (Path(root) / name / name / f"{name}_A.txt").exists():
            graphs, y = load_tu(str(Path(root) / name), name, device=device)
            return graphs, y, {"synthetic": False}
    except FileNotFoundError:
        pass
    from rlap_tpu_torch.data.synthetic import synthetic_graph_dataset

    if name in _SYN_GRAPH_SHAPES:
        ng, lo, hi = _SYN_GRAPH_SHAPES[name]
        graphs, y = synthetic_graph_dataset(num_graphs=ng, n_lo=lo, n_hi=hi,
                                            seed=7, device=device)
        return graphs, y, {"synthetic": True}
    warnings.warn(f"{name}: TU files not found under {root}; using a "
                  f"synthetic ER stand-in")
    graphs, y = synthetic_graph_dataset(num_graphs=128, seed=7,
                                        device=device)
    return graphs, y, {"synthetic": True}


def cca_split(num_nodes: int, splits: Optional[dict], seed: int = 0):
    """The built-in masks when there are any, else 10/10/80 random."""
    if splits is not None:
        return splits
    perm = np.random.default_rng(seed).permutation(num_nodes)
    n_tr, n_va = num_nodes // 10, num_nodes // 10

    def m(idx):
        return np.isin(np.arange(num_nodes), idx)

    return {"train": m(perm[:n_tr]), "valid": m(perm[n_tr:n_tr + n_va]),
            "test": m(perm[n_tr + n_va:])}
