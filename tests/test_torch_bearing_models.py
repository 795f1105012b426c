"""The port's six bearing models without a kernel (HierCorrPool_bearing,
ST_GCN, SAGCN, AGCN_TF, STMSGCN, STNet; gnn_rul_tpu_torch/models/) against
the JAX package's on the CPU at PHM2012/Condition_1 full width, windows of
(1, 2560): the eval forward, the weight round trip and the symbolic-batch
artifact, by the shared checks of tests/test_torch_model_checks.py (their
5 Adam steps are in test_torch_bearing_steps.py); HierCorrPool_bearing's
forward at
XJTU_SY/Condition_1 on the raw minute of 32,768 samples, and its serving
there through ``seq_len``."""

import numpy as np
import pytest
import torch

from gnn_rul_tpu_torch import export
from gnn_rul_tpu_torch.models import MODELS, stnet
from gnn_rul_tpu_torch.train import algorithms

import test_torch_model_checks as checks

METHODS = checks.NO_KERNEL_BEARING
@pytest.fixture(scope="module", params=METHODS)
def method_variables(request):
    return request.param, checks.jax_variables(request.param)


def test_the_six_are_ported():
    assert set(METHODS) <= set(MODELS)
    assert len(MODELS) == 21
    for method in checks.BEARING:
        assert algorithms.get_algorithm_spec(method).model_cls is \
            MODELS[method]


@pytest.mark.parametrize("rows", [2, 4])
def test_eval_output_matches_jax(method_variables, rows):
    """SAGCN's and AGCN_TF's forwards replay the JAX package's frequency
    bins; the port's own differ from them only on ties of value."""
    method, variables = method_variables
    differ = checks.check_eval_forward(method, variables, rows, seed=rows)
    if method not in checks.BINNING:
        assert differ == 0


def test_weight_carry_round_trips_exactly(method_variables):
    checks.check_round_trip(*method_variables)


def test_symbolic_artifact_matches_live_model(method_variables, tmp_path):
    """The STFT, the FFT and the stable sort trace at a symbolic batch; no
    port kernel in the program."""
    program = checks.check_symbolic_artifact(*method_variables, tmp_path)
    assert checks.our_op_nodes(program) == 0


def test_hiercorrpool_bearing_at_xjtu_sy_full_minute():
    """BASELINE.md tier 5's configuration: 64 patches of 512 samples, 17
    bins of 17 frames, at the raw length of 32,768."""
    checks.check_cell_forward("HierCorrPool_bearing", "XJTU_SY",
                              "Condition_1", rows=2, seed=3, length=32768)


def test_serving_takes_the_raw_length_through_seq_len():
    torch.manual_seed(0)
    model = export.build_model("HierCorrPool_bearing", "XJTU_SY",
                               "Condition_1")
    served = export.serving_model("HierCorrPool_bearing", "XJTU_SY",
                                  "Condition_1", model.state_dict(),
                                  seq_len=32768, device="cpu")
    assert served.meta["input_shape"] == [None, 1, 32768]
    x = np.random.default_rng(0).uniform(size=(3, 1, 32768)).astype(
        np.float32)
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(x)).reshape(-1).numpy()
    np.testing.assert_array_equal(served(x), want)
    stale = export.serving_model("HierCorrPool_bearing", "XJTU_SY",
                                 "Condition_1", model.state_dict(),
                                 device="cpu")
    with pytest.raises(ValueError, match="30768"):
        stale(x)


def test_stnet_joins_only_nodes_above_the_threshold():
    w = torch.tensor([[0.7, 0.7000001, -1.0, 2.0]])
    np.testing.assert_array_equal(stnet.high_nodes(w).numpy(),
                                  [[0.0, 1.0, 0.0, 1.0]])


def test_hiercorrpool_bearing_refuses_a_node_count_off_the_stft():
    kwargs = checks.hp("HierCorrPool_bearing")
    with pytest.raises(ValueError, match="bins"):
        MODELS["HierCorrPool_bearing"](**{**kwargs, "num_nodes": 6})
