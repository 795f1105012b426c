"""The port's GAT_LSTM and GDAGDL (gnn_rul_tpu_torch/models/gat_lstm.py,
gdagdl.py), the two bearing models on the graph-attention kernel, against
the JAX package's on the CPU at PHM2012/Condition_1 full width, windows of
(1, 2560), by the shared checks of tests/test_torch_model_checks.py: the
eval forward, the weight round trip, the symbolic-batch artifact (3
``fused_gat`` nodes each) and 5 Adam steps with dropout off (GDAGDL's node
masks the JAX package's, replayed); GDAGDL's train-mode reconstruction
loss; ``gdagdl_pcc`` and ``path_graph`` exactly; GDAGDL's graphs whose
rows, or whole graphs, are all zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu.models import gat_lstm as jax_gat_lstm
from gnn_rul_tpu.models import gdagdl as jax_gdagdl
from gnn_rul_tpu.nn import basic as jax_basic
from gnn_rul_tpu_torch.models import MODELS, gat_lstm, gdagdl
from gnn_rul_tpu_torch.ops.kernels.fused_gat import fused_gat
from gnn_rul_tpu_torch.signal.stft import stft_magnitude

import test_torch_model_checks as checks

METHODS = ("GAT_LSTM", "GDAGDL")
GAT_LAYERS = 3  # hidden_dim and gat_layer_dim at PHM2012/Condition_1


@pytest.fixture(scope="module", params=METHODS)
def method_variables(request):
    return request.param, checks.jax_variables(request.param)


@pytest.mark.parametrize("rows", [2, 4])
def test_eval_output_matches_jax(method_variables, rows):
    """GDAGDL replays the JAX forward's node masks; its own equal them."""
    method, variables = method_variables
    assert checks.check_eval_forward(method, variables, rows,
                                     seed=rows) == 0


def test_weight_carry_round_trips_exactly(method_variables):
    checks.check_round_trip(*method_variables)


def test_symbolic_artifact_matches_live_model(method_variables, tmp_path):
    program = checks.check_symbolic_artifact(*method_variables, tmp_path)
    assert checks.op_nodes(program, "fused_gat") == GAT_LAYERS
    assert checks.our_op_nodes(program) == GAT_LAYERS


def test_gat_lstm_five_adam_steps_match_jax(monkeypatch):
    """The attention's dropout (0.2) off on both sides, so every training
    forward takes the attention operator. The losses hold against JAX.
    The first layer's logits f1_i + f2_j + b keep one side of 0 along
    nearly every row (the statistics' kurtosis, up to ~500, dominates wh),
    where the leaky_relu is linear and f1_i cancels in the row's softmax:
    the gradient of its half of att_kernel comes from the few rows that
    cross 0, a step function of the weights, and Adam's normalised step
    moves it by up to the learning rate whatever its size. After 5 steps
    that half ends 1.6e-3 from JAX's, 1.7e-3 from JAX in fp64, whose own
    fp32 run is 2.0e-3 off it, so no fp32 run holds it; the gradient at
    each step's weights holds, port against JAX (ROADMAP.md Queue 3)."""
    loss_ref, param_ref, _ = checks.check_trajectory(
        "GAT_LSTM", monkeypatch, gradient_held=True)
    assert loss_ref == "jax" and param_ref in ("jax", "jax_fp64",
                                               "gradients")


def test_gdagdl_five_adam_steps_match_jax(monkeypatch):
    """The attention's dropout (0.5) off on both sides; the reconstruction
    loss at weight 1 on both, the node masks the JAX package's. Its
    ``node_importance_linear`` feeds only the step function ``importance >
    0``, so no gradient reaches it: torch's Adam (the port's, the
    reference's) leaves it, the JAX package's moves it by the weight decay,
    as STNet's scorer (ROADMAP.md Queue 3 entry 5)."""
    loss_ref, param_ref, moved = checks.check_trajectory(
        "GDAGDL", monkeypatch, unused=("node_importance_linear",))
    assert (loss_ref, param_ref) == ("jax", "jax")
    assert moved > 1e-3


def test_gdagdl_train_mode_reconstruction_loss_matches_jax(monkeypatch):
    """The autoencoder's reconstruction error, the auxiliary loss
    (tests/test_parity_aux_losses.py::test_gdagdl_recon_loss_parity), with
    the attention's dropout off on both sides."""
    method = "GDAGDL"
    variables = checks.jax_variables(method, seed=3)
    x = checks.x_rows(2, seed=3, method=method)
    monkeypatch.setattr(jax_basic.Dropout, "__call__",
                        lambda self, x, train=False: x)
    own = []
    module, record, answer, differing = checks.REPLAYED[method]
    recorded = record(monkeypatch)
    want_pred, want_recon = checks.jax_model(method).apply(
        variables, jnp.asarray(x), train=True,
        rngs={"dropout": jax.random.PRNGKey(0)})
    checks.replay(monkeypatch, module, recorded, own, answer)
    model = checks.no_dropout(checks.port_model(method, variables)).train()
    with torch.no_grad():
        got_pred, got_recon = model(torch.from_numpy(x))
    assert differing(own) == 0
    np.testing.assert_allclose(float(got_recon), float(want_recon),
                               rtol=checks.FWD_RTOL)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred),
                               atol=checks.FWD_ATOL, rtol=checks.FWD_RTOL)


def test_gdagdl_pcc_matches_jax_exactly():
    """The reference's scrambled "PCC", bit for bit where its arithmetic is
    exact: on integer features whose rows sum to a multiple of f, every
    sum is exact and each remaining operation (the square root, the norms'
    product, the division) rounds once, so any order of the sums gives the
    same bits. That pins the reshape quirk and the unguarded norms (a
    constant row gives 0 / 0). On spectrograms it holds at fp32's
    tolerance: XLA fuses the sums into FMA chains that torch does not."""
    rng = np.random.default_rng(11)
    b, n, f = 64, 3, 6
    feats = rng.integers(-20, 21, size=(b, n, f)).astype(np.float32)
    feats[..., -1] -= feats.sum(-1) % f    # each row sums to k * f
    feats[0, 1] = 7.0                      # a constant row: norm 0
    got = gdagdl.gdagdl_pcc(torch.from_numpy(feats)).numpy()
    want = np.asarray(jax_gdagdl.gdagdl_pcc(jnp.asarray(feats)))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[0, 1]).all() and np.isfinite(got[1:]).all()
    assert np.abs(np.diagonal(got[1:], axis1=1, axis2=2) - 1).max() > 1e-3

    x = checks.x_rows(3, seed=11, method="GDAGDL")
    hp = checks.hp("GDAGDL")
    mag = stft_magnitude(torch.from_numpy(x.reshape(-1, hp["patch_size"])),
                         hp["nperseg"])
    np.testing.assert_allclose(
        gdagdl.gdagdl_pcc(mag).numpy(),
        np.asarray(jax_gdagdl.gdagdl_pcc(jnp.asarray(mag.numpy()))),
        atol=checks.GRAD_ATOL, rtol=checks.GRAD_RTOL)


@pytest.mark.parametrize("n", [1, 2, 40, 80])
def test_path_graph_matches_jax_exactly(n):
    got = gat_lstm.path_graph(n).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_gat_lstm.path_graph(n)))
    assert got.sum() == 3 * n - 2


def test_gdagdl_zero_rows_and_graphs_answer_zero():
    """The outer product of the node masks leaves a row (a node below the
    threshold) or a whole graph (every node below) of the adjacency all
    zero; the attention operator's answer there is exactly 0, and the
    layer's output after ELU too."""
    gen = torch.Generator().manual_seed(0)
    importance = torch.randn(64, 3, generator=gen)
    importance[:8] = -1.0       # eight graphs without a node
    high = gdagdl.high_nodes(importance)
    adj = high[:, :, None] * high[:, None, :]
    wh = torch.randn(64, 3, 300, generator=gen)
    f1, f2 = torch.randn(2, 64, 3, generator=gen)
    out = fused_gat(wh, f1, f2, adj, torch.tensor([0.2]), 0.2)
    zero = (high == 0)
    assert zero[:8].all() and zero[8:].any()
    assert torch.equal(out[zero], torch.zeros_like(out[zero]))
    assert (out[~zero] != 0).all()


def test_gdagdl_joins_only_nodes_above_zero():
    w = torch.tensor([[0.0, 1e-30, -1e-30, 2.0]])
    np.testing.assert_array_equal(gdagdl.high_nodes(w).numpy(),
                                  [[0.0, 1.0, 0.0, 1.0]])


@pytest.mark.parametrize("field", ["num_nodes", "input_dim"])
def test_gdagdl_refuses_widths_off_the_stft(field):
    kwargs = checks.hp("GDAGDL")
    with pytest.raises(ValueError, match="bins"):
        MODELS["GDAGDL"](**{**kwargs, field: kwargs[field] + 1})
