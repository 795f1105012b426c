"""The port's ASTGCNN and ST_Conv (gnn_rul_tpu_torch.models.astgcnn,
.st_conv), the two models on the shared TCN, against the JAX package's at
CMAPSS/FD001 full width on the CPU: the eval forward, the weight round
trip, 5 Adam steps with the BatchNorm statistics and the symbolic-batch
artifact; ST_Conv's reuse of its layer-1 modules, its "same" padding and
the loading of a reference checkpoint that carries its uncalled layer-2
modules; ASTGCNN's gate and bias-free projection."""

import pytest
import torch

from gnn_rul_tpu_torch.models.astgcnn import ASTGCNN
from gnn_rul_tpu_torch.models.st_conv import STConv
from gnn_rul_tpu_torch.ops.graphs import pearson_graph
from gnn_rul_tpu_torch.train import algorithms
from gnn_rul_tpu_torch.train.checkpoint import load_model_dict

import test_torch_model_checks as checks

METHODS = ("ASTGCNN", "ST_Conv")
# The fewest rows any BatchNorm of either model normalizes at STEP_ROWS:
# every BN (the TCN's two, ST_Conv's CNN layer's) sees the 50 steps of each
# window.
BN_ROWS = 4 * 50


@pytest.fixture(scope="module", params=METHODS)
def case(request):
    return request.param, checks.jax_variables(request.param)


@pytest.mark.parametrize("rows", [4, 10])
def test_eval_output_matches_jax(case, rows):
    method, variables = case
    assert checks.check_eval_forward(method, variables, rows,
                                     seed=rows) == 0


def test_weight_carry_round_trips_exactly(case):
    checks.check_round_trip(*case)


@pytest.mark.parametrize("method", METHODS)
def test_five_adam_steps_match_jax(method, monkeypatch):
    """ST_Conv updates each BN twice a step in both packages, so its running
    statistics take the bias-correction gap twice a step, inside the same
    bound."""
    assert checks.check_trajectory(method, monkeypatch,
                                   bn_rows=BN_ROWS) == ("jax", "jax", 0.0)


def test_symbolic_artifact_matches_live_model(case, tmp_path):
    """No port kernel in the program; ST_Conv's "same" padding and
    ASTGCNN's gaussian graph trace at a symbolic batch."""
    program = checks.check_symbolic_artifact(*case, tmp_path)
    assert checks.our_op_nodes(program) == 0


def _st_conv_state(seed=0):
    return checks.from_jax_variables("ST_Conv",
                                     checks.jax_variables("ST_Conv", seed))


def test_st_conv_loads_a_reference_checkpoint_with_layer_2_keys():
    """A state_dict that also carries the reference's uncalled layer-2
    modules (under the names that follow its layer-1 ones, with their own
    TCN's net0/net1), the algorithm's "model." prefix included, loads; the
    layer-1 weights are the ones loaded."""
    sd = _st_conv_state()
    extra = {f"{name}.{k.split('.', 1)[1]}": v.clone() + 1.0
             for k, v in sd.items() for name in STConv.UNCALLED
             if k.startswith(name.replace("2", "1"))}
    extra["tcn_layer_2.net0.0.weight_v"] = torch.ones(3)
    assert len(extra) > 10
    model = STConv(14, 50, 6)
    load_model_dict(model, {f"model.{k}": v for k, v in {**sd,
                                                          **extra}.items()})
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k])


@pytest.mark.parametrize("key", ["gcn_layer_3.theta.0.weight",
                                 "cnn_layer_1.extra", "theta5",
                                 "gcn_layer_2"])
def test_st_conv_still_refuses_any_other_unexpected_key(key):
    sd = {**_st_conv_state(), key: torch.zeros(1)}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_model_dict(STConv(14, 50, 6), sd)


def test_st_conv_reuses_layer_1_and_updates_each_bn_twice():
    """The gate's two branches run the same modules: one training forward
    counts two batches in every BN and its running mean moves by two
    momentum steps."""
    model = checks.port_model("ST_Conv", checks.jax_variables("ST_Conv"))
    x = torch.from_numpy(checks.x_rows(4, seed=3))
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm1d)]
    assert len(bns) == 3
    before = [bn.running_mean.clone() for bn in bns]
    model.train()(x)
    assert [int(bn.num_batches_tracked) for bn in bns] == [2, 2, 2]
    with torch.no_grad():
        pre = model.gcn_layer_1(x, pearson_graph(x))
        batch_mean = model.cnn_layer_1.conv(pre).mean(dim=(0, 2))
    # Two updates by the same batch mean: m <- 0.81 m + 0.19 mean.
    torch.testing.assert_close(bns[0].running_mean,
                               0.81 * before[0] + 0.19 * batch_mean,
                               atol=1e-6, rtol=1e-5)


def test_st_conv_same_padding_is_two_left_three_right():
    """torch's "same" at k = 6 pads (k-1)//2 = 2 on the left and 3 on the
    right, the pair the JAX package passes explicitly."""
    layer = STConv(14, 50, 6).cnn_layer_1.conv
    x = torch.randn(2, 14, 50)
    explicit = torch.nn.functional.conv1d(
        torch.nn.functional.pad(x, (2, 3)), layer.weight, layer.bias)
    with torch.no_grad():
        torch.testing.assert_close(layer(x), explicit)


def test_astgcnn_gate_and_projection():
    """The gate's extra bias starts at 0 beside its Linear's; the graph's
    projection has no bias (its flax path is distance_P/kernel alone); the
    TCN keeps 14 channels, so it has no downsample."""
    model = ASTGCNN(14, 50, 50, 64, 3)
    assert torch.count_nonzero(model.gate.bias) == 0
    assert model.distance_module.P.bias is None
    assert model.tcn.downsample0 is None
    keys = set(model.state_dict())
    assert {"gate.bias", "gate.theta.weight", "gate.theta.bias",
            "distance_module.P.weight"} <= keys
    assert not any(k.startswith("tcn.downsample0") for k in keys)


@pytest.mark.parametrize("method,cls", [("ASTGCNN", ASTGCNN),
                                        ("ST_Conv", STConv)])
def test_build_model_and_spec_resolve(method, cls):
    spec = algorithms.get_algorithm_spec(method)
    assert spec.model_cls is cls and spec.aux_weight is None
    assert isinstance(checks.port_model(method, checks.jax_variables(
        method, seed=3)), cls)
