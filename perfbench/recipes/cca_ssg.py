"""CCA-SSG with rLap views: the program's `CCASSGTrainer` with its `rlap`
augmentor, its plain reference, its layers and its step's count of
work."""

from __future__ import annotations

import torch

from perfbench import program
from perfbench.harness import Recorder
from perfbench.metrics.lib import counts
from perfbench.recipes.lib import rlap_views
from perfbench.reference import nets


class Recipe:
    plumbing = "split"   # rlap_aug: topology and features on split(key)

    def __init__(self, cfg: dict, device):
        self.dev = device
        m, v = cfg["model"], cfg["views"]
        self.hidden, self.out = m["hidden_dim"], m["out_dim"]
        self.layers, self.lam = m["num_layers"], m["lam"]
        self.lr, self.wd = m["lr"], m["weight_decay"]
        self.f = cfg["graph"]["num_features"]
        self.frac, self.pf = v["frac"], v["feature_drop"]
        if (v["o_v"], v["o_n"]) != ("random", "asc"):
            raise ValueError("CCA-SSG's rlap augmentor is o_v=random, "
                             "o_n=asc")
        self.recorders = []

    def dims(self):
        return [self.f] + [self.hidden] * (self.layers - 1) + [self.out]

    def init_weights(self, gen) -> dict:
        d, dims = self.dev, self.dims()
        w = {}
        for i in range(self.layers):
            w[f"net.convs.{i}.lin.weight"] = program.glorot_uniform(
                dims[i + 1], dims[i], gen, d)
            w[f"net.convs.{i}.bias"] = torch.zeros(dims[i + 1], device=d)
        for i in range(self.layers - 1):
            w[f"net.prelu_{i}"] = torch.full((), 0.25, device=d)
        return w

    def build(self, g, weights: dict, seed: int):
        from rlap_tpu_torch.augment.cca_registry import make_cca_augmentor
        from rlap_tpu_torch.models.cca_ssg import CCASSGTrainer

        self.recorders = [Recorder(
            make_cca_augmentor("rlap", self.pf, self.frac))]
        tr = CCASSGTrainer(self.recorders[0], hidden_dim=self.hidden,
                           out_dim=self.out, num_layers=self.layers,
                           lr=self.lr, weight_decay=self.wd, lam=self.lam,
                           seed=seed, device=self.dev)
        tr.ensure_init(g)
        program.load_weights(tr.model, weights)
        return tr

    # -- the check ----------------------------------------------------------
    def view_gap(self, inputs, record, dt=torch.float64) -> float:
        return rlap_views.view_gap(inputs, record, self.frac, self.pf,
                                   self.plumbing, self.dev, dt)

    def reference_train(self, weights: dict, inputs, record,
                        tf32: bool = False, half: bool = False):
        def loss(p, g1, g2, prec):
            return nets.cca_loss(p, nets.with_self_loops(g1),
                                 nets.with_self_loops(g2), self.lam, prec,
                                 self.layers, half)

        return nets.train(loss, weights, rlap_views.pairs(record, self.dev),
                          self.lr, self.wd, tf32)

    # -- layers and work ----------------------------------------------------
    def layer_calls(self, tr, views):
        """The encoder alone on the step's views (with their self-loops),
        forward and backward: (prepare, call)."""
        g1, g2 = views

        def inputs():
            return ()

        def encoder():
            z1 = tr.model.net(g1, g1.x)
            z2 = tr.model.net(g2, g2.x)
            torch.autograd.backward([z1, z2], [torch.ones_like(z1),
                                               torch.ones_like(z2)])

        return {"encoder": (inputs, encoder)}


    def layer_ops(self, layer: str, shapes: dict):
        n = shapes["n"]
        if layer == "encoder":
            # the views carry their self-loops already
            return [o for e in shapes["edges"]
                    for o in counts.gcn_encoder(n, e, self.dims(), False)]
        raise KeyError(layer)

    def step_ops(self, shapes: dict):
        n, d = shapes["n"], self.out
        std = [counts.elementwise("standardize", n * d, 1, 1, 4.0)
               for _ in range(4)]
        return (self.layer_ops("encoder", shapes) + std
                + counts.cca_loss(n, d))
