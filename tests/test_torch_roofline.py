"""The port's speed-of-light model (`rlap_tpu_torch/bench/roofline.py`)
against the JAX package's (`rlap_tpu/bench/roofline.py`), on the CPU.

Where the JAX replay trims no round (its stage budget never binds at
BA(512, 4) and BA(2048, 4)), the two replays share their graph and numpy
stream, so they must give the same rounds, per-round counts and priced
categories; the port is priced here at the JAX module's own constants,
read from it, so that no TPU number enters the port. Also: the replay's
structure (as `tests/test_roofline.py` holds the JAX one), its rounds
against the port's `eliminate`, and the price measurement and the
throughput bench's roofline keys on the host, whose times say nothing
about the card.
"""

import math

import numpy as np
import pytest
import torch

from rlap_tpu.bench import roofline as J
from rlap_tpu_torch.bench import rlap_throughput as RT
from rlap_tpu_torch.bench import roofline as R
from rlap_tpu_torch.core import rng
from rlap_tpu_torch.data.synthetic import barabasi_albert
from rlap_tpu_torch.ops.rlap import _SUBITERS, eliminate

REL = 1e-9  # the two replays add the same float64 terms, grouped otherwise
JAX_PRICES = {"gather": J.NS_GATHER, "scatter": J.NS_SCATTER,
              "sort_arr": J.NS_SORT_ARR, "scan": J.NS_SCAN,
              "elem": J.NS_ELEM}
COUNTS = ("ACT", "C1", "T", "elim")


def _ba(n: int, m: int = 4):
    """The JAX replay's graph: BA(n, m, seed 0), on the host."""
    return barabasi_albert(n, m, seed=0, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of a thread per core in each of them makes every
    small op wait on threads that are not scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", [512, 2048])
def test_replay_matches_the_jax_replay(n):
    ref = J.simulate(n, m=4, frac=0.5, seed=0)
    assert ref["breakdown_ms"]["trim"] == 0  # no round trimmed
    got = R.simulate(_ba(n), frac=0.5, seed=0, prices=JAX_PRICES)
    assert got["rounds"] == ref["rounds"]
    assert got["removed"] == ref["removed"] == n // 2
    assert ([[h[k] for k in COUNTS] for h in got["hist"]]
            == [[h[k] for k in COUNTS] for h in ref["hist"]])
    assert got["entry_exit_ms"] == pytest.approx(ref["entry_exit_ms"],
                                                 rel=REL)
    assert set(got["breakdown_ms"]) == set(ref["breakdown_ms"]) - {"trim"}
    for k, v in got["breakdown_ms"].items():
        assert v == pytest.approx(ref["breakdown_ms"][k], rel=REL), k
    assert got["model_ms"] == pytest.approx(ref["model_ms"], rel=REL)


def test_replay_terminates_and_removes():
    res = R.simulate(_ba(512), frac=0.5, seed=0, prices=JAX_PRICES)
    assert res["rounds"] < 200
    assert res["removed"] == 256
    assert res["model_ms"] > 0
    assert all(v >= 0 for v in res["breakdown_ms"].values())
    assert sum(res["breakdown_ms"].values()) > 0
    assert sum(h["elim"] for h in res["hist"]) == 256


def test_roofline_ms_wrapper_and_linear_prices():
    """`roofline_ms` returns the replay's model; doubling every price
    doubles it (the model is a sum of price x elements)."""
    g = _ba(512)
    ms, res = R.roofline_ms(g, frac=0.5, seed=0, prices=JAX_PRICES)
    assert ms == res["model_ms"]
    twice = {k: 2 * v for k, v in JAX_PRICES.items()}
    ms2, res2 = R.roofline_ms(g, frac=0.5, seed=0, prices=twice)
    assert ms2 == pytest.approx(2 * ms, rel=REL)
    assert res2["rounds"] == res["rounds"]


def test_replay_prices_each_element_once():
    """The model is the elements each primitive handles, entry and exit
    included, times its price; the selection runs the port's
    `_SUBITERS` sub-rounds, each a gather and a scatter-min over both
    ends of every slot with both ends pending; the counts do not depend
    on the prices."""
    g = _ba(512)
    res = R.simulate(g, frac=0.5, seed=0, prices=JAX_PRICES)
    assert set(res["elements"]) == set(res["by_price_ms"]) == set(R.PRICES)
    for k, v in res["elements"].items():
        assert res["by_price_ms"][k] == pytest.approx(
            JAX_PRICES[k] * v / 1e6, rel=REL), k
    assert sum(res["by_price_ms"].values()) == pytest.approx(
        res["model_ms"], rel=REL)
    c1 = sum(h["C1"] for h in res["hist"])
    assert res["breakdown_ms"]["selection"] == pytest.approx(
        _SUBITERS * 2 * c1 * (J.NS_GATHER + J.NS_SCATTER) / 1e6, rel=REL)
    ones = R.simulate(g, frac=0.5, seed=0,
                      prices=dict.fromkeys(R.PRICES, 1.0))
    assert ones["elements"] == res["elements"]
    assert ones["by_price_ms"] == pytest.approx(
        {k: v / 1e6 for k, v in res["elements"].items()})


def test_replay_needs_every_price():
    with pytest.raises(ValueError, match="scan"):
        R.simulate(_ba(64, 2), prices={k: 1.0 for k in R.PRICES
                                       if k != "scan"})
    with pytest.raises(TypeError):
        R.simulate(_ba(64, 2))  # no default table: the card's are measured


def test_replay_rounds_near_the_ports_eliminate():
    """At BA(2048, 4), t = n/2: the median of `eliminate`'s rounds over
    keys 0-2 within 3 of the replay's."""
    n = 2048
    g = _ba(n)
    rounds = []
    for k in range(3):
        _out, removed, rnd = eliminate(g, rng.key(k, device="cpu"), n // 2)
        assert removed == n // 2
        rounds.append(rnd)
    res = R.simulate(g, frac=0.5, seed=0, prices=JAX_PRICES)
    assert abs(np.median(rounds) - res["rounds"]) <= 3, (rounds,
                                                         res["rounds"])


def test_measure_prices_on_the_cpu():
    """At E = 2**16 both sizes take the same path of each torch op (the
    CPU sort changes algorithm at 2**15 elements), and the added work of
    2E stands above the host's noise when the suite's workers share it;
    still, host prices say nothing about the card, and only their being
    finite is held here (their sign is the card's test's)."""
    res = R.measure_prices("cpu", n=2000, e=1 << 16, reps=10)
    assert set(res["prices_ns"]) == set(res["fixed_ms"]) == set(R.PRICES)
    assert all(math.isfinite(v) for v in res["prices_ns"].values()), res
    assert res["max_abs_err"] == {"take": 0, "scatter_min": 0}
    assert res["launches"] == {"take": 0, "scatter_min": 0}  # plain on host
    assert res["device"] == "cpu" and res["timer"] == "host clock"
    for k in R.PRICES:
        assert res["fixed_ms"][k] == pytest.approx(
            2 * res["ms"][k] - res["ms_twice"][k])


def test_measure_prices_refuses_empty_sizes():
    with pytest.raises(ValueError):
        R.measure_prices("cpu", n=2000, e=0)


def test_throughput_run_prints_the_roofline_on_the_cpu():
    n = 2000
    res = RT.run(n=n, device="cpu", reps=1)
    assert res["removed"] == n // 2
    assert set(res["prices_ns"]) == set(res["price_fixed_ms"]) \
        == set(R.PRICES)
    # finite: host prices say nothing about the card, whose test holds
    # their sign; at this graph's E (31,378) the host's sort even changes
    # algorithm between E and 2E
    assert all(math.isfinite(v) for v in res["prices_ns"].values())
    assert res["price_checks"]["n"] == n
    assert res["price_checks"]["e"] == res["directed_edges"]
    assert res["price_checks"]["max_abs_err"] == {"take": 0,
                                                  "scatter_min": 0}
    assert res["roofline_fraction"] == pytest.approx(
        res["roofline_ms"] / res["ms_per_call"])
    model = R.simulate(_ba(n, RT.M), frac=RT.FRAC, seed=0,
                       prices=res["prices_ns"])
    assert res["roofline_ms"] == pytest.approx(model["model_ms"])
    assert res["roofline_rounds"] == model["rounds"]
    assert res["roofline_breakdown_ms"] == pytest.approx(
        model["breakdown_ms"])
    assert res["roofline_entry_exit_ms"] == pytest.approx(
        model["entry_exit_ms"])
    assert res["roofline_elements"] == model["elements"]
    assert res["roofline_by_price_ms"] == pytest.approx(
        model["by_price_ms"])
    assert res["prices_s"] > 0 and res["replay_s"] > 0
    # the traced call: a span on the host, no card here
    assert res["traced_call_ms"] > 0
    assert res["traced_call_device_busy_ms"] == 0
    assert res["traced_call_kernels"] == 0
