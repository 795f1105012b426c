"""The port's RGCNU (gnn_rul_tpu_torch.models.rgcnu) against the JAX
package's at CMAPSS/FD001 full width on the CPU: the eval forward, the
train-mode (pred, std) and gradients, the A.repeat(L, 1, 1) pairing, the
'same' padding, GCNLayer's activations, the weight round trip, 5 Adam steps
with the std unused and the symbolic-batch artifact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu.compat import import_torch_state_dict
from gnn_rul_tpu.nn.gnn_blocks import GCNLayer as JaxGCNLayer
from gnn_rul_tpu_torch.models.rgcnu import RGCNU, FusionModule
from gnn_rul_tpu_torch.nn.gnn_blocks import GCNLayer
from gnn_rul_tpu_torch.train import algorithms
from gnn_rul_tpu_torch.train.algorithms import resolve_aux_weight

import test_torch_model_checks as checks

METHOD = "RGCNU"


@pytest.fixture(scope="module")
def variables():
    return checks.jax_variables(METHOD)


@pytest.mark.parametrize("rows", [4, 10])
def test_eval_output_matches_jax(variables, rows):
    assert checks.check_eval_forward(METHOD, variables, rows,
                                     seed=rows) == 0


def test_train_mode_pred_std_and_gradients_match_jax(variables, monkeypatch):
    """Train mode with dropout off on both sides: (pred, std) and the
    gradient of mean(pred^2) + mean(std^2), every parameter against
    jax.grad."""
    monkeypatch.setattr(checks.jax_basic.Dropout, "__call__",
                        lambda self, x, train=False: x)
    x = checks.x_rows(4, seed=0)
    jmodel = checks.jax_model(METHOD)

    def loss(params):
        pred, std = jmodel.apply({"params": params}, jnp.asarray(x),
                                 train=True,
                                 rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean(pred ** 2) + jnp.mean(std ** 2), (pred, std)

    (_, want_out), want_grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    model = checks.no_dropout(checks.port_model(METHOD, variables)).train()
    pred, std = model(torch.from_numpy(x))
    for got, want in zip((pred, std), want_out):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=2e-4, rtol=1e-4)
    (torch.mean(pred ** 2) + torch.mean(std ** 2)).backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    got = import_torch_state_dict(METHOD, grads, checks.hp(METHOD))["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(
        checks.numpy_tree(want_grads)))
    leaves = jax.tree_util.tree_leaves_with_path(checks.numpy_tree(got))
    assert len(leaves) == len(want)
    for path, leaf in leaves:
        np.testing.assert_allclose(leaf, want[path], atol=2e-4, rtol=1e-4,
                                   err_msg=str(path))


def test_repeat_pairs_sample_b_step_l_with_adjacency_bl_mod_b(variables):
    """The SCL's adjacency for flat index k = b*L + l is A[k % B], the
    reference's A.repeat(L, 1, 1), not sample b's own A[b]."""
    model = checks.port_model(METHOD, variables).eval()
    x = torch.from_numpy(checks.x_rows(3, seed=1))
    seen = {}

    def keep_adjacency(mod, args, out):
        seen["adj"] = args[1]

    model.scl.gcn1.register_forward_hook(keep_adjacency)
    with torch.no_grad():
        model(x)
        own = model.adj(x)
    b, _, l = x.shape
    k = torch.arange(b * l)
    assert torch.equal(seen["adj"], own[k % b])
    assert not torch.equal(seen["adj"], own.repeat_interleave(l, dim=0))


@pytest.mark.parametrize("kernel_size", [3, 4])
def test_same_padding_matches_jax(kernel_size):
    """The fusion convolution pads (k-1)//2 on the left and k//2 on the
    right, as the JAX RGCNU's nn.Conv pads, also for an even k."""
    hp = {**checks.hp(METHOD), "kernel_size": kernel_size}
    jmodel = checks.jalgorithms.get_algorithm_spec(METHOD).model_cls(**hp)
    x = checks.x_rows(2, seed=2)
    variables = checks.numpy_tree(dict(jmodel.init(
        jax.random.PRNGKey(5), jnp.asarray(x), train=False)))
    model = RGCNU(**hp)
    model.load_state_dict(checks.from_jax_variables(METHOD, variables),
                          strict=True)
    assert isinstance(model.fusion, FusionModule)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(
        variables, jnp.asarray(x), train=False)), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("activation", ["leaky_relu", "relu", "none"])
def test_gcn_layer_activations_match_jax(activation):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 6, 5)).astype(np.float32)
    adj = (rng.uniform(size=(3, 6, 6)) > 0.5).astype(np.float32)
    jlayer = JaxGCNLayer(7, activation=activation)
    jvars = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(adj))
    dense = checks.numpy_tree(jvars["params"])["linear"]["Dense_0"]
    layer = GCNLayer(5, 7, activation=activation)
    with torch.no_grad():
        layer.linear.weight.copy_(torch.from_numpy(dense["kernel"].T))
        layer.linear.bias.copy_(torch.from_numpy(dense["bias"]))
        got = layer(torch.from_numpy(x), torch.from_numpy(adj)).numpy()
    want = np.asarray(jlayer.apply(jvars, jnp.asarray(x), jnp.asarray(adj)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    if activation != "none":
        assert (got < 0).any() == (activation == "leaky_relu")
    with pytest.raises(ValueError, match="activation"):
        GCNLayer(5, 7, activation="tanh")


def test_weight_carry_round_trips_exactly(variables):
    checks.check_round_trip(METHOD, variables)


def test_five_adam_steps_match_jax(monkeypatch):
    """Five steps; the std head is produced and unused (aux weight 0), so
    it has no gradient: torch's Adam, the reference's, skips it, while the
    JAX package's adds the weight decay into a zero gradient and Adam
    moves every weight of the head by about the learning rate a step
    (ROADMAP.md, Queue 3). Every other parameter holds against JAX."""
    assert resolve_aux_weight(algorithms.get_algorithm_spec(METHOD),
                              checks.TRAIN_PARAMS) == 0.0
    losses, params, jax_moved = checks.check_trajectory(
        METHOD, monkeypatch, unused=("fusion_fc2",))
    assert (losses, params) == ("jax", "jax")
    assert 4e-3 < jax_moved <= checks.STEPS * 1e-3 + 1e-6


def test_symbolic_artifact_matches_live_model(variables, tmp_path):
    program = checks.check_symbolic_artifact(METHOD, variables, tmp_path)
    assert checks.our_op_nodes(program) == 0


def test_build_model_and_spec_resolve_rgcnu():
    spec = algorithms.get_algorithm_spec(METHOD)
    assert spec.model_cls is RGCNU and spec.aux_weight == "__zero__"
    keys = RGCNU(**checks.hp(METHOD)).state_dict()
    assert sorted({k.split(".")[0] for k in keys}) == [
        "adj", "fusion", "scl", "tdl"]
