"""GRACE with rLap views: the program's `GraceTrainer`, its plain
reference, its layers and its step's count of work."""

from __future__ import annotations

import torch

from perfbench import program
from perfbench.harness import Recorder
from perfbench.metrics.lib import counts
from perfbench.recipes.lib import rlap_views
from perfbench.reference import nets


class Recipe:
    plumbing = "compose"   # Compose([RLap, FeatureMasking]): fold_in(key, i)

    def __init__(self, cfg: dict, device):
        self.dev = device
        m, v = cfg["model"], cfg["views"]
        self.hidden, self.layers = m["hidden_dim"], m["num_layers"]
        self.proj, self.tau = m["proj_dim"], m["tau"]
        self.lr, self.wd = m["lr"], m["weight_decay"]
        self.f = cfg["graph"]["num_features"]
        self.frac, self.pf = v["frac"], v["feature_mask"]
        self.o_v, self.o_n = v["o_v"], v["o_n"]
        if self.proj != self.hidden:
            raise ValueError("GraceTrainer projects to its hidden width")
        self.recorders = []

    def init_weights(self, gen) -> dict:
        d, h = self.dev, self.hidden
        w = {}
        dims = [self.f] + [h] * self.layers
        for i in range(self.layers):
            w[f"encoder.convs.{i}.lin.weight"] = program.glorot_uniform(
                dims[i + 1], dims[i], gen, d)
            w[f"encoder.convs.{i}.bias"] = torch.zeros(h, device=d)
            w[f"encoder.acts.{i}.slope"] = torch.full((), 0.25, device=d)
        for fc in ("fc1", "fc2"):
            w[f"project.{fc}.weight"] = program.lecun_normal(h, h, gen, d)
            w[f"project.{fc}.bias"] = torch.zeros(h, device=d)
        return w

    def build(self, g, weights: dict, seed: int):
        from rlap_tpu_torch.augment.base import Compose
        from rlap_tpu_torch.augment.feature import FeatureMasking
        from rlap_tpu_torch.augment.rlap import RLap
        from rlap_tpu_torch.models.grace import GraceTrainer

        self.recorders = [Recorder(Compose([
            RLap(self.frac, o_v=self.o_v, o_n=self.o_n, device=self.dev),
            FeatureMasking(self.pf)])) for _ in range(2)]
        tr = GraceTrainer(*self.recorders, hidden_dim=self.hidden,
                          num_layers=self.layers, lr=self.lr,
                          weight_decay=self.wd, tau=self.tau, seed=seed,
                          device=self.dev)
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
            return nets.grace_loss(p, g1, g2, self.tau, prec, self.layers,
                                   half)

        return nets.train(loss, weights, rlap_views.pairs(record, self.dev),
                          self.lr, self.wd, tf32)

    # -- layers and work ----------------------------------------------------
    def layer_calls(self, tr, views):
        """Each layer alone on the step's tensors, forward and backward:
        (prepare, call)."""
        g1, g2 = views

        def enc_inputs():
            return ()

        def encoder():
            z1 = tr.model.encoder(g1, g1.x)
            z2 = tr.model.encoder(g2, g2.x)
            torch.autograd.backward([z1, z2], [torch.ones_like(z1),
                                               torch.ones_like(z2)])

        def loss_inputs():
            with torch.no_grad():
                h1, h2 = tr.model(g1, g2)
            return h1.requires_grad_(), h2.requires_grad_()

        def loss(h1, h2):
            tr.contrast(h1, h2, node_mask=g1.node_mask).backward()

        return {"encoder": (enc_inputs, encoder), "loss": (loss_inputs, loss)}

    def loss_ops(self, n: int):
        ops = []
        for _ in range(2):
            ops += counts.l2norm(n, self.proj) + counts.infonce(n, self.proj)
        return ops

    def layer_ops(self, layer: str, shapes: dict):
        n = shapes["n"]
        if layer == "encoder":
            dims = [self.f] + [self.hidden] * self.layers
            return [o for e in shapes["edges"]
                    for o in counts.gcn_encoder(n, e, dims, loops=True)]
        if layer == "loss":
            return self.loss_ops(n)
        raise KeyError(layer)

    def step_ops(self, shapes: dict):
        n, h = shapes["n"], self.hidden
        head = []
        for _ in range(2):
            head += [counts.matmul(n, h, h), counts.matmul(n, h, h)]
            head += counts.linear_bwd(n, h, h) + counts.linear_bwd(n, h, h)
        return (self.layer_ops("encoder", shapes) + head
                + self.layer_ops("loss", shapes))
