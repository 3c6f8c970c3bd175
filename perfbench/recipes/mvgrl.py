"""MVGRL with its rLap-then-PPR diffusion views: the program's
`MVGRLTrainer` with the registry's `rLapPPRDiffusion` pair, its plain
reference (`reference/mvgrl.py`, `reference/ppr.py`), its layers and the
diffusion series' count of work.

A step's record, in the order it is made: `view1` (the graph with its
features masked); on a fresh call, `schur`, the Schur complement; `view`
(view 2: the diffusion view with its features masked, marked cached
where the cache answered); `mask`, the subsample's node masks of both
views, under the key the mask was drawn from; `perm`, the two
corruption permutations, under the key they were split from.
"""

from __future__ import annotations

import torch

from perfbench import program
from perfbench.harness import Recorder, graph_dict, moved
from perfbench.metrics.lib import counts
from perfbench.reference import keys, nets
from perfbench.reference import mvgrl as ref_mvgrl
from perfbench.reference import ppr as ref_ppr
from perfbench.reference import rlap as ref_rlap

AUGMENTOR = "rLapPPRDiffusion"
# a dropped diffusion entry within this share of the row's bar is a
# near-tie: float32 against float64 moves entries by ~1e-6 of themselves
TIE = 1e-4


class Recipe:
    def __init__(self, cfg: dict, device):
        self.dev = device
        m, v = cfg["model"], cfg["views"]
        self.hidden, self.layers = m["hidden_dim"], m["num_layers"]
        self.lr, self.wd = m["lr"], m["weight_decay"]
        self.f = cfg["graph"]["num_features"]
        if v["augmentor"] != AUGMENTOR or (v["o_v"], v["o_n"]) != (
                "random", "asc"):
            raise ValueError(f"the mvgrl recipe runs the registry's "
                             f"{AUGMENTOR} pair (o_v=random, o_n=asc)")
        self.frac, self.pf = v["frac"], v["feature_mask"]
        self.alpha, self.eps, self.iters = v["alpha"], v["eps"], v["iters"]
        self.every, self.subsample = v["refresh_every"], v["subsample"]
        self.recorders = []
        self.ppr_nnz = None

    def init_weights(self, gen) -> dict:
        d, h = self.dev, self.hidden
        w = {}
        dims = [self.f] + [h] * self.layers
        for enc in ("encoder1", "encoder2"):
            for i in range(self.layers):
                w[f"{enc}.convs.{i}.lin.weight"] = program.glorot_uniform(
                    dims[i + 1], dims[i], gen, d)
                w[f"{enc}.convs.{i}.bias"] = torch.zeros(h, device=d)
            w[f"{enc}.act.slope"] = torch.full((h,), 0.25, device=d)
        w["project.weight"] = program.lecun_normal(h, h, gen, d)
        w["project.bias"] = torch.zeros(h, device=d)
        return w

    def build(self, g, weights: dict, seed: int):
        from rlap_tpu_torch.augment.registry import make_augmentor_pair
        from rlap_tpu_torch.models.mvgrl import MVGRLTrainer

        a1, a2 = make_augmentor_pair(AUGMENTOR, self.frac, self.frac,
                                     pf=self.pf, device=self.dev)
        cache = a2.augmentors[0]
        self.diffusion = cache.inner
        got = (self.diffusion.alpha, self.diffusion.eps,
               self.diffusion.iters, cache.refresh_every)
        if got != (self.alpha, self.eps, self.iters, self.every):
            raise ValueError(f"the registry's {AUGMENTOR} takes (alpha, eps, "
                             f"iters, refresh_every) = {got}")
        view1, view2 = Recorder(a1, "view1"), Recorder(a2, "view")
        cache.inner = view2.fresh(self.diffusion)
        schur = Recorder(self.diffusion.rlap, "schur")
        self.diffusion.rlap = schur
        tr = MVGRLTrainer(view1, view2, augmentor_name=AUGMENTOR,
                          hidden_dim=self.hidden, num_layers=self.layers,
                          lr=self.lr, weight_decay=self.wd,
                          subsample=self.subsample, seed=seed,
                          device=self.dev)
        tr.ensure_init(g)
        program.load_weights(tr.model, weights)
        # the permutations' key is split off the trainer's inside the call;
        # the mask's is the fourth of the four the views split off it
        tr.corruption = Recorder(tr.corruption, "perm",
                                 key=lambda n: tr.key.initial_seed())
        mask = Recorder(lambda seed, out: (out[0].node_mask,
                                           out[1].node_mask), "mask",
                        key=lambda seed, out: keys.split(seed, 4)[3])
        views = tr.views

        def masked_views(g, keys=None):
            seed = tr.key.initial_seed()
            out = views(g, keys)
            mask(seed, out)
            return out

        tr.views = masked_views
        self.recorders = [view1, view2, schur, tr.corruption, mask]
        self.g = g
        return tr

    # -- the check ----------------------------------------------------------
    def view_gap(self, inputs, record, dt=torch.float64) -> float:
        """The largest of (a) the Schur complements against
        `ppr.schur_complement` of their keys (edges in one and not the
        other, plus the largest relative weight gap), (b) the diffusion
        views against the float64 S of the recorded complement
        (`ppr.view_gaps`: the largest relative weight gap plus the
        entries no near-tie explains), and (c) the record's rules, one
        for each broken: a fresh view 2 on every `refresh_every`-th call
        and on no other, each cached one the last fresh one's edges bit
        for bit; view 1 the graph's edges; each view's features masked as
        its key masks them; each mask the one its key draws, the same in
        both views, of at least `subsample` nodes, each with an edge of
        view 2 other than a self-loop; each permutation the one its key
        draws. With `dt` below float64, the reference at `dt` (the
        sampler in float32, the series with TF32 products) takes the
        program's complements and diffusion views' place: the control."""
        g = graph_dict(inputs, self.dev)
        n = g["num_nodes"]
        k = max(min(g["senders"].shape[0] // n, n), 1)
        by = {}
        for e in record:
            by.setdefault(e.what, []).append(e)
        a = b = c = 0.0
        schur = iter(by.get("schur", []))
        last = None
        for i, e in enumerate(by.get("view", [])):
            v = moved(e.value, self.dev)
            fresh = i % self.every == 0
            c += float(e.cached == fresh)
            if e.cached:
                c += float(last is None or any(
                    not torch.equal(v[x], last[x])
                    for x in ("senders", "receivers", "weights")))
                continue
            last = v
            sc = next(schur, None)
            if sc is None:
                c += 1.0
                continue
            mine = moved(sc.value, self.dev)
            ref_keys, ref_w = ref_ppr.schur_complement(g, sc.key, self.frac)
            if dt != torch.float64:
                lo_keys, lo_w = ref_ppr.schur_complement(g, sc.key, self.frac,
                                                         dt)
                mine = dict(mine, senders=lo_keys // (n + 1),
                            receivers=lo_keys % (n + 1),
                            weights=lo_w.to(torch.float32))
            a = max(a, _complement_gap(mine, ref_keys, ref_w))
            live = mine["senders"] < n
            sr, rr, wr = (mine[x][live] for x in ("senders", "receivers",
                                                  "weights"))
            s64 = ref_ppr.ppr(sr, rr, wr, n, self.alpha, self.iters)
            if dt == torch.float64:
                vl = v["senders"] < n
                rows, cols, vals = (v["senders"][vl], v["receivers"][vl],
                                    v["weights"][vl])
            else:
                rows, cols, vals = ref_ppr.top_k(
                    ref_ppr.ppr(sr, rr, wr, n, self.alpha, self.iters, dt,
                                tf32=True), k, self.eps)
            gap, wrong = ref_ppr.view_gaps(s64, rows, cols, vals, k,
                                           self.eps, TIE)
            b = max(b, gap + wrong)
            del s64
        c += sum(1.0 for _ in schur)
        c += self._rules(g, by)
        return max(a, b, c)

    def _rules(self, g: dict, by: dict) -> float:
        n, dev = g["num_nodes"], self.dev
        bad = 0.0
        for what in ("view1", "view"):
            for e in by.get(what, []):
                v = moved(e.value, dev)
                want = ref_rlap.masked_features(
                    g["x"], keys.generator(keys.fold_in(e.key, 1), dev),
                    self.pf)
                bad += float(not torch.equal(v["x"], want))
                if what == "view1":
                    bad += float(any(not torch.equal(v[x], g[x]) for x in
                                     ("senders", "receivers", "weights")))
        view2 = by.get("view", [])
        for i, e in enumerate(by.get("mask", [])):
            m1, m2 = moved(e.value, dev)
            v = moved(view2[i].value, dev) if i < len(view2) else None
            if v is None or m1 is None or m2 is None:
                bad += float(n > self.subsample or v is None)
                continue
            s, r = v["senders"], v["receivers"]
            deg = torch.zeros(n + 1, dtype=torch.int64, device=dev)
            deg.index_add_(0, s, ((s < n) & (s != r)).long())
            u = torch.rand(n, generator=keys.generator(e.key, dev),
                           device=dev)
            score = torch.where(deg[:n] > 0, u, torch.full_like(u, -1.0))
            want = score >= torch.sort(score).values[-self.subsample] \
                .clamp_min(0.0)
            bad += float(not torch.equal(m1, m2))
            bad += float(not torch.equal(m1, want))
            bad += float(int(m1.sum()) < self.subsample)
            bad += float(bool((m1 & (deg[:n] == 0)).any()))
        for e in by.get("perm", []):
            kc = keys.split(e.key)[1]
            for kp, got in zip(keys.split(kc), e.value):
                want = torch.randperm(n, generator=keys.generator(kp, dev),
                                      device=dev)
                bad += float(not torch.equal(got.to(dev), want))
        steps = len(by.get("view1", []))
        bad += float(any(len(by.get(w, [])) != steps
                         for w in ("view", "mask", "perm")))
        return bad

    def reference_train(self, weights: dict, inputs, record,
                        tf32: bool = False, half: bool = False):
        """The recorded steps, from the same weights: each step's views,
        cut to its mask, and its permutations."""
        by = {}
        for e in record:
            by.setdefault(e.what, []).append(moved(e.value, self.dev))
        steps = []
        for v1, v2, (m1, m2), (p1, p2) in zip(by["view1"], by["view"],
                                               by["mask"], by["perm"]):
            steps.append((dict(v1, node_mask=m1, perm=p1),
                          dict(v2, node_mask=m2, perm=p2)))

        def loss(p, v1, v2, prec):
            return ref_mvgrl.loss(p, v1, v2, prec, self.layers, half)

        return nets.train(loss, weights, steps, self.lr, self.wd, tf32)

    # -- layers and work ----------------------------------------------------
    def layer_calls(self, tr, views):
        """Each layer alone, on the step's views or the run's graph:
        (prepare, call). `encoder`: both encoders, clean and corrupted,
        forward and backward; `diffusion`: one whole build of view 2;
        `ppr`: the series alone, on a complement made in `prepare`."""
        from rlap_tpu_torch.augment.diffusion import compute_ppr_dense

        g1, g2 = views
        n = g1.num_nodes

        def key():
            gen = torch.Generator(device=self.dev)
            gen.manual_seed(0x5EED)
            return gen

        def enc_inputs():
            gen = key()
            return tuple(torch.randperm(n, generator=gen, device=self.dev)
                         for _ in range(2))

        def encoder(p1, p2):
            m = tr.model
            zs = [m.encoder1(g1, g1.x), m.encoder2(g2, g2.x),
                  m.encoder1(g1, g1.x[p1]), m.encoder2(g2, g2.x[p2])]
            torch.autograd.backward(zs, [torch.ones_like(z) for z in zs])

        def build():
            self.diffusion(self.g, key())

        def complement():
            sc = self.diffusion.rlap(self.g, key())
            self.ppr_nnz = int(sc.edge_mask.sum())
            return (sc,)

        def series(sc):
            compute_ppr_dense(sc, self.alpha, self.iters, add_self_loop=False)

        return {"encoder": (enc_inputs, encoder),
                "diffusion": (lambda: (), build),
                "ppr": (complement, series)}

    def layer_ops(self, layer: str, shapes: dict):
        """`ppr`: each step of the series on the complement `prepare`
        made, one sparse product of the dense [n, n] S over T's nonzero
        entries (the (1 - alpha) folded into T's weights) and alpha added
        to the n diagonal entries, read and written."""
        if layer != "ppr" or self.ppr_nnz is None:
            raise KeyError(layer)
        n = shapes["n"]
        return [o for _ in range(self.iters)
                for o in (counts.spmm(n, self.ppr_nnz, n, "ppr_spmm"),
                          counts.elementwise("ppr_diagonal", n, 1, 1))]


def _complement_gap(mine: dict, ref_keys, ref_w) -> float:
    """Directed edges in one complement and not the other, plus an edge
    twice, plus the largest relative gap of a shared edge's weight."""
    n = mine["num_nodes"]
    live = mine["senders"] < n
    k = mine["senders"][live] * (n + 1) + mine["receivers"][live]
    w = mine["weights"][live].double()
    uk, inv = torch.unique(k, return_inverse=True)
    twice = k.numel() - uk.numel()
    ws = torch.zeros(uk.shape[0], dtype=torch.float64,
                     device=k.device).index_add_(0, inv, w)
    shared = torch.isin(uk, ref_keys)
    differ = (uk.numel() - int(shared.sum())) \
        + (ref_keys.numel() - int(shared.sum())) + twice
    at = torch.searchsorted(ref_keys, uk[shared])
    gap = float(((ws[shared] - ref_w[at]).abs()
                 / ref_w[at].abs().clamp_min(1e-300)).max()) \
        if at.numel() else 0.0
    return differ + gap
