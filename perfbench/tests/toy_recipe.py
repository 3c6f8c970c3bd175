"""The stub recipe of the recipe contract's test, copied into a test
checkout as `recipes/toy_diffusion.py`: glue to the toy program
(`toy_program.py`) and a plain reference of its own, which imports
nothing of the program: the diffusion in float64 by a dense solve, the
toy loss by dense products, Adam written out. Its view check judges the
cache too: a fresh view is due on every `refresh_every`-th call, and each
cached view is the one the due call's key makes."""

from __future__ import annotations

import torch

from perfbench import program
from perfbench.harness import Recorder, graph_dict, moved
from perfbench.reference import keys, nets


def diffusion(g: dict, seed: int, alpha: float, drop: float,
              dt=torch.float64) -> torch.Tensor:
    """The dense [n, n] view the key `seed` makes."""
    n, dev = g["num_nodes"], g["senders"].device
    live = g["senders"] < n
    s, r = g["senders"][live], g["receivers"][live]
    keep = torch.rand(s.shape[0], generator=keys.generator(seed, dev),
                      device=dev) >= drop
    a = torch.zeros(n, n, dtype=dt, device=dev)
    a[r[keep], s[keep]] = 1.0
    eye = torch.eye(n, dtype=dt, device=dev)
    a = torch.maximum(a, a.T) + eye
    d = a.sum(1).rsqrt()
    return alpha * torch.linalg.solve(eye - (1 - alpha) * d[:, None] * a
                                      * d[None, :], eye)


def dense(view: dict, dt=torch.float64) -> torch.Tensor:
    n = view["num_nodes"]
    a = torch.zeros(n, n, dtype=dt, device=view["senders"].device)
    return a.index_put_((view["receivers"], view["senders"]),
                        view["weights"].to(dt), accumulate=True)


class Recipe:
    def __init__(self, cfg: dict, device):
        self.dev = device
        m, v = cfg["model"], cfg["views"]
        self.hidden, self.lr = m["hidden_dim"], m["lr"]
        self.alpha, self.drop = v["alpha"], v["drop"]
        self.every = v["refresh_every"]
        self.f = cfg["graph"]["num_features"]
        self.recorders = []

    def init_weights(self, gen) -> dict:
        d, h = self.dev, self.hidden
        return {"lin.weight": program.glorot_uniform(h, self.f, gen, d),
                "project.weight": program.glorot_uniform(h, h, gen, d),
                "project.bias": torch.zeros(h, device=d)}

    def build(self, g, weights: dict, seed: int):
        from rlap_tpu_torch.augment.base import CachedAugmentor

        from perfbench.tests import toy_program as toy

        views = Recorder(what="view")
        views.fn = CachedAugmentor(
            views.fresh(toy.Diffusion(self.alpha, self.drop)), self.every)
        tr = toy.ToyTrainer(views, self.f, self.hidden, self.lr, seed,
                            self.dev)
        # the permutation's key is split off the trainer's inside the call
        tr.corruption = Recorder(tr.corruption, "perm",
                                 key=lambda n: tr.key.initial_seed())
        self.recorders = [views, tr.corruption]
        program.load_weights(tr.model, weights)
        return tr

    # -- the check ----------------------------------------------------------
    def view_gap(self, inputs, record, dt=torch.float64) -> float:
        """Per view: 1 where it was cached and a fresh one was due, or the
        other way round, plus its largest gap to the reference's view of
        the due call's key over the largest entry. Per permutation: 1 where
        it is not the one drawn from the second half of its key's split. With `dt` below float64 the
        reference at `dt` takes the views' place."""
        g = graph_dict(inputs, self.dev)
        gap, due = 0.0, None
        views = [e for e in record if e.what == "view"]
        for i, e in enumerate(views):
            fresh = i % self.every == 0
            due = e.key if fresh else due
            gap += float(e.cached == fresh)
            ref = diffusion(g, due, self.alpha, self.drop)
            mine = (dense(moved(e.value, self.dev)) if dt == torch.float64
                    else diffusion(g, due, self.alpha, self.drop, dt))
            gap += float((mine - ref).abs().max() / ref.abs().max())
        for e in record:
            if e.what == "perm":
                gen = keys.generator(keys.split(e.key)[1], self.dev)
                want = torch.randperm(g["num_nodes"], generator=gen,
                                      device=self.dev)
                gap += float(not torch.equal(e.value.to(self.dev), want))
        return gap

    def reference_train(self, weights: dict, inputs, record,
                        tf32: bool = False, half: bool = False):
        """The toy steps on the recorded views and permutations."""
        x = inputs.x.to(self.dev)
        views = [dense(moved(e.value, self.dev), torch.float32)
                 for e in record if e.what == "view"]
        perms = [e.value.to(self.dev) for e in record if e.what == "perm"]
        rows = x.shape[0] // 2 if half else x.shape[0]

        def loss(p, a, perm, prec):
            h = prec.mm(x, p["lin.weight"].T)
            z, zc = prec.mm(a, h), prec.mm(a, h[perm])
            s = prec.mm(torch.sigmoid(z.mean(0))[None],
                        p["project.weight"].T)[0] + p["project.bias"]
            pos, neg = (z @ s)[:rows], (zc @ s)[:rows]
            return (torch.nn.functional.softplus(-pos).mean()
                    + torch.nn.functional.softplus(neg).mean())

        return nets.train(loss, weights, list(zip(views, perms)), self.lr,
                          0.0, tf32)
