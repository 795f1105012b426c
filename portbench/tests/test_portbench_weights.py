"""Weights and state from ``--seed``: specs without a centre draw the same
tensors bit for bit as before a spec could carry one (digests of the
parameters of the two configurations that existed then, taken on the CPU
before the change); a centred spec draws inside ``centre ± bound``; every
BatchNorm that FC_STGNN loads holds a positive running variance."""

import hashlib

import pytest
import torch

from portbench.harness.cell import load
from portbench.harness.common import make_weights

CPU = torch.device("cpu")
DIGESTS = {
    ("hagcn-fd001.serve", 7):
        "c5fc4d635f5669ed26e97858cc95b228341fd7385449e509dd45affba4eaef5b",
    ("hagcn-fd001.serve", 2 ** 33 + 5):
        "85aa94513f50390aa7e50744d7654e3b9bc56dba0ff3c6988cb4b5215594da6d",
    ("logo_bearing-phm2012.serve", 7):
        "10f4beb5074b42937d6a5aec56d5ddee4d21e33e0f44581763764ca1c48497e2",
    ("logo_bearing-phm2012.serve", 2 ** 33 + 5):
        "9970f97f0551b1af492a99aecda2feee440fd1f99f5b1eeb8b32777193d59a58",
}


def _digest(specs, weights) -> str:
    h = hashlib.sha256()
    for name, *_ in specs:
        h.update(name.encode())
        h.update(weights[name].contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("workload,seed", sorted(DIGESTS))
def test_three_field_specs_draw_what_they_drew(workload, seed):
    cell = load(workload)
    specs = cell.reference.param_specs(cell.config)
    assert all(len(s) == 3 for s in specs)
    assert _digest(specs, make_weights(specs, seed, CPU)) == \
        DIGESTS[workload, seed]


def test_a_centre_moves_the_draw_and_keeps_the_order():
    plain = [("a", (3,), 0.5), ("b", (4, 2), 0.25), ("c", (2,), 1.0)]
    centred = [("a", (3,), 0.5), ("b", (4, 2), 0.25, 3.0), ("c", (2,), 1.0)]
    for seed in (1, 2 ** 40 + 9):
        p = make_weights(plain, seed, CPU)
        c = make_weights(centred, seed, CPU)
        assert torch.equal(p["a"], c["a"]) and torch.equal(p["c"], c["c"])
        assert torch.equal(c["b"], p["b"] + 3.0)
        assert 2.75 <= float(c["b"].min()) and float(c["b"].max()) <= 3.25


def test_a_zero_bound_draws_the_centre():
    w = make_weights([("n", (), 0.0), ("v", (5,), 0.0, 1.0)], 3, CPU)
    assert w["n"].shape == () and float(w["n"]) == 0.0
    assert torch.equal(w["v"], torch.ones(5))


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_fc_stgnn_loads_its_batch_norms_with_positive_variance(seed):
    from gnn_rul_tpu_torch.export import build_model
    cell = load("fc_stgnn-fd003.serve")
    cfg = cell.config
    specs = cell.reference.param_specs(cfg)
    weights = make_weights(specs, seed, CPU)
    model = build_model(cfg["method"], cfg["dataset"], cfg["dataset_id"])
    assert set(weights) == set(model.state_dict())
    model.load_state_dict(weights, strict=True)
    variances = [v for k, v in model.state_dict().items()
                 if k.endswith("running_var")]
    assert len(variances) == 7
    assert all(float(v.min()) >= 0.5 and float(v.max()) <= 1.5
               for v in variances)
    x = torch.rand((3, 14, 50), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.isfinite(model.eval()(x)).all()
