"""The port's recipe CLI and what it stands on, against the JAX package's:
the config (`run_name`, JSON, `sweep` with skip-if-exists) and the
command line, exact; the JSONL logger, each package reading the other's
files; the loaders on the golden fixtures and the synthetic stand-ins,
array for array; and `run_one` / `main` for all five recipes on the CPU,
which write the JAX CLI's events with its field names."""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

import rlap_tpu.cli.run as jcli
import rlap_tpu.data.loaders as JL
import rlap_tpu.utils.config as JC
import rlap_tpu.utils.logging as JLOG
import rlap_tpu_torch.cli.run as cli
import rlap_tpu_torch.data.loaders as L
import rlap_tpu_torch.utils.config as C
import rlap_tpu_torch.utils.logging as LOG
from rlap_tpu_torch.data.synthetic import synthetic_graph_dataset

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of a thread per core in each of them makes every
    small op wait on threads that are not scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_graph(tg, jg):
    assert tg.num_nodes == jg.num_nodes
    for name in ("senders", "receivers", "weights", "x"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# config and command line
# ---------------------------------------------------------------------------

CONFIGS = [dict(), dict(recipe="bgrl", dataset="MUTAG", lr=1e-2, seed=3),
           dict(recipe="cca_ssg", augmentor="ed_evc", fraction1=0.35,
                weight_decay=0.0, hidden_dim=512, lam=5e-4)]


@pytest.mark.parametrize("kw", CONFIGS)
def test_config_matches_jax(kw):
    t, j = C.ExperimentConfig(**kw), JC.ExperimentConfig(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.run_name() == j.run_name()
    assert t.to_json() == j.to_json()
    assert C.ExperimentConfig.from_json(j.to_json()) == t


def test_sweep_matches_jax_and_skips_done(tmp_path):
    grid = dict(augmentor=["rLap", "EdgeDropping"], lr=[1e-2, 1e-3],
                fraction1=[0.1, 0.3])
    base = C.ExperimentConfig(recipe="mvgrl")
    jbase = JC.ExperimentConfig(recipe="mvgrl")
    names = [c.run_name() for c in C.sweep(base, str(tmp_path), **grid)]
    assert names == [c.run_name()
                     for c in JC.sweep(jbase, str(tmp_path), **grid)]
    assert len(names) == 8
    for name in names[:3]:
        (tmp_path / f"{name}.jsonl").write_text("")
    left = [c.run_name() for c in C.sweep(base, str(tmp_path), **grid)]
    assert left == names[3:] == [c.run_name() for c in JC.sweep(
        jbase, str(tmp_path), **grid)]


def _options(main, capsys):
    with pytest.raises(SystemExit):
        main(["--help"])
    text = capsys.readouterr().out
    return {w.rstrip(",") for w in text.split() if w.startswith("--")}


def test_help_lists_every_jax_option_and_device(capsys):
    ours, theirs = _options(cli.main, capsys), _options(jcli.main, capsys)
    assert ours == theirs | {"--device"}, (ours ^ theirs)


def test_command_line_types():
    """The fields' own types, as in the JAX CLI: --lr a float, --seed an
    int."""
    a = cli.parser().parse_args(["--lr", "0.01", "--seed", "3",
                                 "--hidden-dim", "64", "--device", "cpu"])
    assert a.lr == 0.01 and isinstance(a.lr, float)
    assert a.seed == 3 and isinstance(a.seed, int)
    assert a.hidden_dim == 64 and a.device == "cpu"


@pytest.mark.parametrize("recipe", ["grace", "graphcl", "cca_ssg"])
def test_sweep_grids_match_jax(recipe, monkeypatch, tmp_path):
    """`--sweep` visits the JAX CLI's points, in its order."""
    seen = {"port": [], "jax": []}
    monkeypatch.setattr(cli, "run_one",
                        lambda c, **kw: seen["port"].append(c.run_name()))
    monkeypatch.setattr(jcli, "run_one",
                        lambda c, **kw: seen["jax"].append(c.run_name()))
    argv = ["--sweep", "--recipe", recipe, "--results-dir", str(tmp_path)]
    cli.main(argv)
    jcli.main(argv)
    assert seen["port"] == seen["jax"] and len(seen["port"]) >= 150


# ---------------------------------------------------------------------------
# logging
# ---------------------------------------------------------------------------

def _write(mod, path, acc):
    log = mod.MetricsLogger(path=str(path), run_id="r", echo=False,
                            recipe="grace", dataset="CORA", augmentor="rLap")
    log.metric("final_loss", 1.5, step=3)
    log.log("test_run", repeat=0, accuracy=acc, micro_f1=acc, macro_f1=acc)


def test_logs_read_across_packages(tmp_path):
    ours, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    _write(LOG, ours, 0.5)
    _write(JLOG, theirs, 0.75)
    with open(ours, "a") as f:
        f.write('{"truncated": ')  # a run killed while writing
    for path in (ours, theirs):
        mine = list(LOG.read_metrics(str(path)))
        other = list(JLOG.read_metrics(str(path)))
        assert len(mine) == 2
        for a, b in zip(mine, other):
            assert a == b
        assert set(mine[0]) == {"ts", "run_id", "event", "recipe", "dataset",
                                "augmentor", "name", "value", "step"}
    paths = [str(ours), str(theirs)]
    assert LOG.aggregate(paths, "final_loss") == JLOG.aggregate(
        paths, "final_loss")
    for fmt in ("markdown", "latex"):
        assert LOG.results_table(paths, fmt=fmt) == JLOG.results_table(
            paths, fmt=fmt)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

def test_planetoid_fixture_matches_jax():
    g, y, splits = L.load_planetoid(os.path.join(FIX, "planetoid"), "tiny",
                                    device="cpu")
    jg, jy, jsplits = JL.load_planetoid(os.path.join(FIX, "planetoid"),
                                        "tiny")
    assert_same_graph(g, jg)
    np.testing.assert_array_equal(y, jy)
    for k in jsplits:
        np.testing.assert_array_equal(splits[k], jsplits[k])


def test_npz_fixture_matches_jax():
    path = os.path.join(FIX, "tiny_academic.npz")
    (g, y), (jg, jy) = L.load_npz_graph(path, device="cpu"), \
        JL.load_npz_graph(path)
    assert_same_graph(g, jg)
    np.testing.assert_array_equal(y, jy)


def _write_tu(root, name, graphs, labels):
    """The graphs in the TU text format, node labels from the degree."""
    d = root / name
    d.mkdir(parents=True)
    a, ind, nl, off = [], [], [], 0
    for gi, g in enumerate(graphs):
        m = g.edge_mask
        for s, r in zip(g.senders[m].tolist(), g.receivers[m].tolist()):
            a.append(f"{s + off + 1}, {r + off + 1}")
        deg = torch.bincount(g.senders[m], minlength=g.num_nodes)
        ind += [str(gi + 1)] * g.num_nodes
        nl += [str(min(int(k), 3)) for k in deg]
        off += g.num_nodes
    (d / f"{name}_A.txt").write_text("\n".join(a) + "\n")
    (d / f"{name}_graph_indicator.txt").write_text("\n".join(ind) + "\n")
    (d / f"{name}_graph_labels.txt").write_text(
        "\n".join(str(2 * int(v) - 1) for v in labels) + "\n")
    (d / f"{name}_node_labels.txt").write_text("\n".join(nl) + "\n")


@pytest.fixture(scope="module")
def tu_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("tu")
    graphs, y = synthetic_graph_dataset(num_graphs=24, n_lo=6, n_hi=12,
                                        seed=2, device="cpu")
    _write_tu(root, "SYNTU", graphs, y)
    return root


@pytest.mark.parametrize("where", ["fixture", "written"])
def test_tu_matches_jax(where, tu_root):
    root, name = ((os.path.join(FIX, "TINY"), "TINY") if where == "fixture"
                  else (str(tu_root), "SYNTU"))
    graphs, y = L.load_tu(root, name, device="cpu")
    jgraphs, jy = JL.load_tu(root, name)
    np.testing.assert_array_equal(y, jy)
    assert len(graphs) == len(jgraphs)
    for g, jg in zip(graphs, jgraphs):
        assert_same_graph(g, jg)
    # and through the registry, the files found under the root
    got, gy, meta = L.load_graph_dataset(name, root=root, device="cpu")
    assert meta == {"synthetic": False} and len(got) == len(graphs)


@pytest.mark.parametrize("name", ["CORA", "PUBMED", "UNKNOWN-NODE"])
def test_node_stand_ins_match_jax(name, monkeypatch):
    for mod in (L, JL):
        monkeypatch.setitem(mod._SYN_SHAPES, name, (150, 3, 700))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if name == "UNKNOWN-NODE":
            with pytest.raises(KeyError):
                L.load_dataset(name, root="/nonexistent", device="cpu")
            return
        g, y, meta = L.load_dataset(name, root="/nonexistent", device="cpu")
        jg, jy, jmeta = JL.load_dataset(name, root="/nonexistent")
    assert meta == jmeta == {"synthetic": True, "splits": None}
    assert g.x.shape == (150, 512)  # feature width capped at 512
    assert_same_graph(g, jg)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("name", ["MUTAG", "COLLAB"])
def test_graph_stand_ins_match_jax(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        graphs, y, meta = L.load_graph_dataset(name, root="/nonexistent",
                                               device="cpu")
        jgraphs, jy, jmeta = JL.load_graph_dataset(name, root="/nonexistent")
    assert meta == jmeta == {"synthetic": True}
    np.testing.assert_array_equal(y, jy)
    assert len(graphs) == len(jgraphs) == (188 if name == "MUTAG" else 128)
    for g, jg in zip(graphs[:20], jgraphs[:20]):
        assert_same_graph(g, jg)


def test_cca_split_matches_jax():
    for seed in (0, 3):
        got, want = L.cca_split(57, None, seed), JL.cca_split(57, None, seed)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    masks = {"train": np.ones(3, bool)}
    assert L.cca_split(3, masks) is masks


# ---------------------------------------------------------------------------
# run_one and main
# ---------------------------------------------------------------------------

NODE_SHAPE = (128, 4, 32)


@pytest.fixture()
def small_data(monkeypatch, tu_root):
    for mod in (L, JL):
        monkeypatch.setitem(mod._SYN_SHAPES, "CORA", NODE_SHAPE)
    monkeypatch.setenv("RLAP_TPU_DATA", str(tu_root))
    warnings.simplefilter("ignore")


def _records(path):
    return list(LOG.read_metrics(str(path)))


def _schema(recs):
    """Event -> field names (and metric names)."""
    out = {}
    for r in recs:
        key = r["event"] if r["event"] != "metric" else "metric:" + r["name"]
        out[key] = set(r)
    return out


@pytest.fixture(scope="module")
def jax_schemas(tmp_path_factory, tu_root):
    """The JAX CLI's JSONL for a node recipe and a graph recipe, from a
    short run on the same small data."""
    out = tmp_path_factory.mktemp("jaxcli")
    mp = pytest.MonkeyPatch()
    mp.setitem(JL._SYN_SHAPES, "CORA", NODE_SHAPE)
    mp.setenv("RLAP_TPU_DATA", str(tu_root))
    schemas = {}
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for recipe, ds in (("grace", "CORA"), ("graphcl", "SYNTU")):
                cfg = JC.ExperimentConfig(recipe=recipe, dataset=ds,
                                          augmentor="EdgeDropping",
                                          hidden_dim=8, max_epochs=2)
                jcli.run_one(cfg, results_dir=str(out), eval_repeats=2)
                schemas[recipe] = _schema(_records(
                    out / f"{cfg.run_name()}.jsonl"))
    finally:
        mp.undo()
    return schemas


RUNS = [("grace", "CORA", "EdgeDroppingPR"), ("mvgrl", "CORA", "PPRDiffusion"),
        ("cca_ssg", "CORA", "rlap"), ("graphcl", "SYNTU", "rLap"),
        ("bgrl", "SYNTU", "rLap")]


@pytest.mark.parametrize("recipe,dataset,augmentor", RUNS)
def test_run_one_on_the_cpu(recipe, dataset, augmentor, small_data,
                            jax_schemas, tmp_path):
    """Two epochs, two evaluation repeats, the JAX CLI's events and
    fields; then a second call with the same checkpoint directory resumes
    the finished run and trains no epoch."""
    cfg = C.ExperimentConfig(recipe=recipe, dataset=dataset,
                             augmentor=augmentor, hidden_dim=8,
                             max_epochs=2, tolerance=5)
    ck = str(tmp_path / "ck")
    cli.run_one(cfg, results_dir=str(tmp_path), eval_repeats=2,
                checkpoint_dir=ck, checkpoint_every=1, device="cpu")
    path = tmp_path / f"{cfg.run_name()}.jsonl"
    recs = _records(path)
    want = jax_schemas["graphcl" if dataset == "SYNTU" else "grace"]
    assert _schema(recs) == want
    assert [r["repeat"] for r in recs if r["event"] == "test_run"] == [0, 1]
    final = [r for r in recs if r.get("name") == "final_loss"]
    assert np.isfinite(final[0]["value"]) and final[0]["step"] == 2
    for r in recs:
        if r["event"] == "test_run":
            assert 0 <= r["accuracy"] <= 1
    path.unlink()
    cli.run_one(cfg, results_dir=str(tmp_path), checkpoint_dir=ck,
                device="cpu")
    again = [r for r in _records(path) if r.get("name") == "final_loss"]
    assert np.isnan(again[0]["value"]) and again[0]["step"] == 1


def test_main_on_the_cpu(small_data, tmp_path):
    cli.main(["--recipe", "grace", "--dataset", "CORA", "--augmentor",
              "EdgeDropping", "--hidden-dim", "8", "--max-epochs", "2",
              "--results-dir", str(tmp_path), "--device", "cpu"])
    (path,) = tmp_path.glob("*.jsonl")
    cfg = C.ExperimentConfig(augmentor="EdgeDropping", hidden_dim=8,
                             max_epochs=2)
    assert path.name == f"{cfg.run_name()}.jsonl"
    recs = _records(path)
    assert recs[0]["event"] == "config" and recs[0]["max_epochs"] == 2
    assert json.loads(cfg.to_json()) == {
        k: recs[0][k] for k in dataclasses.asdict(cfg)}


def test_run_one_defaults_to_the_card(small_data):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises((RuntimeError, AssertionError)):
        cli.run_one(C.ExperimentConfig(max_epochs=1))
