"""Traffic and data drawn the same from the same seed, and every seed
sending the same sizes."""

import numpy as np
import pytest

from portbench.harness import serve
from portbench.harness.cell import load
from portbench.harness.common import make_weights, make_windows, rng, sub_seed

SEED = 2 ** 33 + 5
SERVING = ["hagcn-fd001.serve", "logo_bearing-phm2012.serve",
           "fc_stgnn-fd003.serve"]


def test_schedule_repeats_from_the_seed():
    mix = load("hagcn-fd001.serve").traffic
    a = serve.schedule(mix, SEED, mix["pool_windows"], 500)
    b = serve.schedule(mix, SEED, mix["pool_windows"], 500)
    c = serve.schedule(mix, SEED + 1, mix["pool_windows"], 500)
    assert a == b
    assert a != c


@pytest.mark.parametrize("workload", SERVING)
def test_every_seed_sends_the_same_sizes_each_cycle(workload):
    mix = load(workload).traffic
    levels = serve.sizes_of(mix)
    assert levels == mix["sizes"] and max(levels) <= mix["pool_windows"]
    for seed in (0, SEED, 2 ** 31 - 1):
        sizes, offsets = serve.schedule(mix, seed, mix["pool_windows"],
                                        3 * len(levels))
        for k in range(3):
            cycle = sizes[k * len(levels):(k + 1) * len(levels)]
            assert sorted(cycle) == sorted(levels)
        assert all(0 <= o <= mix["pool_windows"] - n
                   for n, o in zip(sizes, offsets))


def test_windows_and_weights_repeat_from_the_seed():
    import torch
    for name in SERVING:
        cell = load(name)
        spec = cell.config["input"]
        a = make_windows(spec, 8, rng(SEED, "traffic.pool"))
        b = make_windows(spec, 8, rng(SEED, "traffic.pool"))
        assert a.dtype == np.float32
        assert a.shape == (8, spec["channels"], spec["length"])
        np.testing.assert_array_equal(a, b)
        assert spec["low"] <= a.min() and a.max() <= spec["high"]
        specs = cell.reference.param_specs(cell.config)
        w1 = make_weights(specs, SEED, torch.device("cpu"))
        w2 = make_weights(specs, SEED, torch.device("cpu"))
        assert all(torch.equal(w1[k], w2[k]) for k in w1)
        assert all((w1[k] - (c[0] if c else 0.0)).abs().max() <= b
                   for k, _, b, *c in specs)


def test_sub_seeds_take_large_seeds():
    assert sub_seed(2 ** 40 + 3, "a") != sub_seed(3, "a")
    assert sub_seed(7, "a") != sub_seed(7, "b")
    assert 0 <= sub_seed(2 ** 62, "weights") < 2 ** 32
