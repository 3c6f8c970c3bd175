"""The plain reference against itself, on toy GRACE and CCA-SSG steps:
the blocked and checkpointed InfoNCE against the dense formula, the GCN by
gather against a dense normalised adjacency, Adam written out against
torch's, and the rLap views against the program's on the same key."""

import pytest
import torch

from perfbench.reference import keys, nets
from perfbench.reference import rlap as ref_rlap

torch.manual_seed(0)


def _toy_graph(n=30, p=0.2, f=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(n, n, generator=g) < p
    a = torch.triu(a, 1)
    s, r = torch.nonzero(a | a.T, as_tuple=True)
    pad = torch.full((5,), n)
    return {"senders": torch.cat([s, pad]), "receivers": torch.cat([r, pad]),
            "weights": torch.cat([torch.ones(s.shape[0]), torch.zeros(5)]),
            "x": torch.randn(n, f, generator=g), "num_nodes": n}


def _dense_norm(g, loops):
    n = g["num_nodes"]
    a = torch.zeros(n, n)
    live = g["senders"] < n
    a[g["receivers"][live], g["senders"][live]] = g["weights"][live]
    if loops:
        a.fill_diagonal_(1.0)
    d = a.sum(0)
    dinv = torch.where(d > 0, d.rsqrt(), torch.zeros_like(d))
    return dinv[:, None] * a * dinv[None, :]


def _dense_infonce(a, b, tau):
    a = a / a.norm(dim=1, keepdim=True)
    b = b / b.norm(dim=1, keepdim=True)
    return -torch.log_softmax(a @ b.T / tau, 1).diagonal().mean()


def test_blocked_infonce_is_the_dense_formula_with_its_gradient():
    a = torch.randn(37, 5, requires_grad=True)
    b = torch.randn(37, 5, requires_grad=True)
    blocked = nets.infonce(a, b, 0.2, nets.Precision(), block=8)
    dense = _dense_infonce(a, b, 0.2)
    assert float(blocked.detach()) == pytest.approx(float(dense.detach()),
                                                    rel=1e-6)
    ga = torch.autograd.grad(blocked, [a, b])
    gd = torch.autograd.grad(dense, [a, b])
    for x, y in zip(ga, gd):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("loops", [True, False])
def test_gcn_by_gather_is_the_dense_normalised_product(loops):
    g = _toy_graph()
    p = {"c.lin.weight": torch.randn(4, 6), "c.bias": torch.randn(4)}
    out = nets.gcn_layer(p, "c", g, g["x"], nets.Precision(), loops)
    dense = _dense_norm(g, loops) @ (g["x"] @ p["c.lin.weight"].T) \
        + p["c.bias"]
    torch.testing.assert_close(out, dense, rtol=1e-5, atol=1e-6)


def test_adam_written_out_is_torchs_with_l2_decay():
    w = torch.randn(7, 3)
    mine = {"w": w.clone()}
    opt = nets.Adam(mine, lr=1e-2, weight_decay=1e-3)
    ref = torch.nn.Parameter(w.clone())
    topt = torch.optim.Adam([ref], lr=1e-2, weight_decay=1e-3)
    for _ in range(3):
        grad = torch.randn(7, 3)
        opt.step(mine, {"w": grad})
        ref.grad = grad.clone()
        topt.step()
    torch.testing.assert_close(mine["w"], ref.detach(), rtol=1e-6,
                               atol=1e-7)


def _grace_params(f=6, h=8):
    p = {}
    dims = [f, h, h]
    for i in range(2):
        p[f"encoder.convs.{i}.lin.weight"] = torch.randn(h, dims[i]) * 0.3
        p[f"encoder.convs.{i}.bias"] = torch.randn(h) * 0.1
        p[f"encoder.acts.{i}.slope"] = torch.tensor(0.25)
    for fc in ("fc1", "fc2"):
        p[f"project.{fc}.weight"] = torch.randn(h, h) * 0.3
        p[f"project.{fc}.bias"] = torch.randn(h) * 0.1
    return p


def test_toy_grace_step_is_its_dense_form():
    g1, g2 = _toy_graph(seed=1), _toy_graph(seed=2)
    p = _grace_params()

    def dense(g):
        x, an = g["x"], _dense_norm(g, True)
        for i in range(2):
            x = an @ (x @ p[f"encoder.convs.{i}.lin.weight"].T) \
                + p[f"encoder.convs.{i}.bias"]
            x = torch.where(x >= 0, x, 0.25 * x)
        z = torch.nn.functional.elu(x @ p["project.fc1.weight"].T
                                    + p["project.fc1.bias"])
        return z @ p["project.fc2.weight"].T + p["project.fc2.bias"]

    h1, h2 = dense(g1), dense(g2)
    want = 0.5 * (_dense_infonce(h1, h2, 0.2) + _dense_infonce(h2, h1, 0.2))
    got = nets.grace_loss(p, g1, g2, 0.2, nets.Precision(), 2)
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_toy_cca_step_is_its_dense_form_and_repeats():
    g1 = nets.with_self_loops(_toy_graph(seed=3))
    g2 = nets.with_self_loops(_toy_graph(seed=4))
    p = {"net.convs.0.lin.weight": torch.randn(8, 6) * 0.3,
         "net.convs.0.bias": torch.zeros(8),
         "net.convs.1.lin.weight": torch.randn(8, 8) * 0.3,
         "net.convs.1.bias": torch.zeros(8),
         "net.prelu_0": torch.tensor(0.25)}

    def z(g):
        an = _dense_norm(g, False)
        x = an @ (g["x"] @ p["net.convs.0.lin.weight"].T)
        x = torch.where(x >= 0, x, 0.25 * x)
        x = an @ (x @ p["net.convs.1.lin.weight"].T)
        x = (x - x.mean(0)) / (x.std(0, unbiased=False)
                               * x.shape[0] ** 0.5)
        return x

    z1, z2 = z(g1), z(g2)
    eye = torch.eye(8)
    want = -torch.trace(z1.T @ z2) + 1e-3 * (
        ((eye - z1.T @ z1) ** 2).sum() + ((eye - z2.T @ z2) ** 2).sum())
    got = nets.cca_loss(p, g1, g2, 1e-3, nets.Precision(), 2)
    assert float(got) == pytest.approx(float(want), rel=1e-4)

    def loss(q, a, b, prec):
        return nets.cca_loss(q, a, b, 1e-3, prec, 2)

    once = nets.train(loss, p, [(g1, g2)] * 2, 1e-3, 0.0)
    twice = nets.train(loss, p, [(g1, g2)] * 2, 1e-3, 0.0)
    assert once[0] == twice[0]
    assert once[0][1] < once[0][0]


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.0])
    assert nets.tf32_round(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                           3.0]


def test_rlap_view_is_the_programs_on_the_same_key():
    from rlap_tpu_torch.augment.base import Compose
    from rlap_tpu_torch.augment.feature import FeatureMasking
    from rlap_tpu_torch.augment.rlap import RLap
    from rlap_tpu_torch.core import rng
    from rlap_tpu_torch.data.synthetic import barabasi_albert

    g = barabasi_albert(300, 3, seed=1, device="cpu")
    g = g.replace(x=torch.randn(300, 8))
    d = {"senders": g.senders, "receivers": g.receivers,
         "weights": g.weights, "x": g.x, "num_nodes": 300}
    aug = Compose([RLap(0.2, device="cpu"), FeatureMasking(0.3)])
    for seed in (5, 2 ** 40 + 3):
        out = aug(g, rng.key(seed, device="cpu"))
        edges, x = ref_rlap.view(d, seed, 0.2, 0.3, "compose")
        live = out.senders < 300
        mine = torch.sort(out.senders[live] * 301 + out.receivers[live])[0]
        assert torch.equal(mine, edges)
        assert torch.equal(out.x, x)
        # the eliminated nodes are isolated in the view
        deg = torch.bincount(edges // 301, minlength=300)
        assert int((deg == 0).sum()) >= int(0.2 * 300)


def test_key_plumbing_is_the_programs():
    from rlap_tpu_torch.core import rng

    k = rng.key(2 ** 35 + 9, device="cpu")
    assert [c.initial_seed() for c in rng.split(k, 3)] == keys.split(
        2 ** 35 + 9, 3)
    assert rng.fold_in(k, 1).initial_seed() == keys.fold_in(2 ** 35 + 9, 1)
