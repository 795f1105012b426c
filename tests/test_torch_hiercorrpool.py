"""The port's HierCorrPool (gnn_rul_tpu_torch.models.hiercorrpool) against
the JAX package's on the CPU: at CMAPSS/FD001 full width the eval forward,
the weight round trip, 5 Adam steps with the BatchNorm statistics and the
symbolic-batch artifact; the forward at FD004's tier-3 widths; the 3-block
encoder, the regrouping and the cluster assignment on their own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu.nn.encoders import FeatureExtractor1DCNN as JaxEncoder
from gnn_rul_tpu_torch.configs.hparams import model_hparams
from gnn_rul_tpu_torch.models.hiercorrpool import HierCorrPool
from gnn_rul_tpu_torch.nn.encoders import FeatureExtractor1DCNN
from gnn_rul_tpu_torch.train import algorithms

import test_torch_model_checks as checks

METHOD = "HierCorrPool"
# The fewest rows any BatchNorm of the model normalizes at STEP_ROWS: the
# encoder's three BNs see 3 steps a window at FD001 (patches of 2 -> conv
# 3), so 4 x 3.
BN_ROWS = 4 * 3


@pytest.fixture(scope="module")
def variables():
    return checks.jax_variables(METHOD)


@pytest.mark.parametrize("rows", [4, 10])
def test_eval_output_matches_jax(variables, rows):
    assert checks.check_eval_forward(METHOD, variables, rows,
                                     seed=rows) == 0


def test_weight_carry_round_trips_exactly(variables):
    checks.check_round_trip(METHOD, variables)


def test_five_adam_steps_match_jax(monkeypatch):
    """Dropout (0.35, after the encoder's first block) off on both sides.
    The losses hold against JAX; the parameters end 9.8e-4 from JAX's (in
    the encoder's conv3 kernel), where JAX's own fp32 run is 9.8e-4 off the
    same steps in fp64 and the port's 4.5e-5, so they hold against JAX in
    fp64 (tests/test_torch_model_checks.py:hold). The running statistics
    hold within the bias-correction bound at 12 rows a BN."""
    assert checks.check_trajectory(METHOD, monkeypatch, bn_rows=BN_ROWS) == (
        "jax", "jax_fp64", 0.0)


def test_symbolic_artifact_matches_live_model(variables, tmp_path):
    """The regrouping's reshape (b, eck, N, -1) traces at a symbolic batch;
    no port kernel in the program."""
    program = checks.check_symbolic_artifact(METHOD, variables, tmp_path)
    assert checks.our_op_nodes(program) == 0


def test_fd004_forward_matches_jax():
    """Tier 3 (BASELINE.md): FD004's patches of 10 x 5 and
    encoder_conv_kernel 12, whose encoder gives (B, 560, 3) and nodes of
    120 features."""
    assert model_hparams("CMAPSS", "FD004", METHOD)["patch_size"] == 10
    checks.check_cell_forward(METHOD, "CMAPSS", "FD004", rows=5, seed=4)


@pytest.mark.parametrize("dataset_id,steps,node_dim", [("FD001", 2, 80),
                                                       ("FD004", 3, 120)])
def test_encoder_length_and_node_features(dataset_id, steps, node_dim):
    """The encoder's output length, by out_length and by running it, and
    the node features it regroups into."""
    hp = model_hparams("CMAPSS", dataset_id, METHOD)
    model = HierCorrPool(**hp).eval()
    enc = model.Time_Preprocessing
    x = torch.zeros(3, 14 * hp["patch_size"], hp["num_patch"])
    assert enc.out_length(hp["num_patch"]) == steps
    assert tuple(enc(x).shape) == (3, 560, steps)
    assert model.gc1.Message_Passing.theta[0].in_features == node_dim


@pytest.mark.parametrize("length,stride", [(2, 1), (5, 1), (13, 2)])
def test_encoder_matches_jax(length, stride):
    """FeatureExtractor1DCNN alone, eval mode with running statistics moved
    off (0, 1): the three blocks' convolutions, BNs and padded max pools, and
    the output's 4 x num_hidden channels."""
    rng = np.random.default_rng(length)
    x = rng.normal(size=(2, 6, length)).astype(np.float32)
    jenc = JaxEncoder(5, kernel_size=4, stride=stride)
    jvars = checks.numpy_tree(dict(jenc.init(jax.random.PRNGKey(length),
                                             jnp.asarray(x), train=False)))
    jvars["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.uniform(size=a.shape) + 0.5).astype(np.float32),
        jvars["batch_stats"])
    want = np.asarray(jenc.apply(jvars, jnp.asarray(x), train=False))
    enc = FeatureExtractor1DCNN(6, 5, kernel_size=4, stride=stride).eval()
    sd = {}
    for i in (1, 2, 3):
        p = jvars["params"][f"bn{i}"]["BatchNorm1d_0"]["BatchNorm_0"]
        s = jvars["batch_stats"][f"bn{i}"]["BatchNorm1d_0"]["BatchNorm_0"]
        sd.update({
            f"conv_block{i}.0.weight": torch.tensor(
                jvars["params"][f"conv{i}"]["Conv_0"]["kernel"]
                .transpose(2, 1, 0)),
            f"conv_block{i}.1.weight": torch.tensor(p["scale"]),
            f"conv_block{i}.1.bias": torch.tensor(p["bias"]),
            f"conv_block{i}.1.running_mean": torch.tensor(s["mean"]),
            f"conv_block{i}.1.running_var": torch.tensor(s["var"]),
            f"conv_block{i}.1.num_batches_tracked": torch.tensor(0)})
    enc.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 20, enc.out_length(length))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_cluster_assignment_sums_to_one_over_the_nodes(variables):
    """The softmax runs over the node axis: each of the 6 clusters' columns
    of S sums to 1 over the 14 nodes, and the pooled graph is 6 x 6."""
    model = checks.port_model(METHOD, variables).eval()
    rng = np.random.default_rng(5)
    gc = torch.from_numpy(rng.normal(size=(3, 14, 80)).astype(np.float32))
    adj = torch.softmax(gc @ gc.transpose(1, 2), dim=-1)
    with torch.no_grad():
        s = model.gc1.Graph_Clustering(gc, adj)
        a_pool, out = model.gc1(adj, gc)
    assert tuple(s.shape) == (3, 14, 6)
    torch.testing.assert_close(s.sum(dim=1), torch.ones(3, 6))
    assert tuple(a_pool.shape) == (3, 6, 6) and tuple(out.shape) == (3, 6,
                                                                     240)


def test_build_model_and_spec_resolve():
    spec = algorithms.get_algorithm_spec(METHOD)
    assert spec.model_cls is HierCorrPool and spec.aux_weight is None
    model = checks.port_model(METHOD, checks.jax_variables(METHOD, seed=3))
    assert sorted({k.split(".")[0] for k in model.state_dict()}) == [
        "Time_Preprocessing", "fc_0", "fc_1", "gc1"]
    assert sum(isinstance(m, torch.nn.Dropout) for m in model.modules()) == 1
