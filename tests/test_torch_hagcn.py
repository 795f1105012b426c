"""The port's HAGCN (gnn_rul_tpu_torch.models.hagcn) against the JAX
package's at CMAPSS/FD001 full width on the CPU: the eval forward (its
Bi-LSTM on the JAX package's CPU scan and on the port's plain recurrence),
SAGPool and its KL, the train-mode output and KL and their gradients, the
weight round trip, 5 Adam steps at the bank's alpha and the symbolic-batch
artifact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu.compat import import_torch_state_dict
from gnn_rul_tpu.models.hagcn import SAGPool as JaxSAGPool
from gnn_rul_tpu.train import algorithms as jalgorithms
from gnn_rul_tpu_torch.models.hagcn import HAGCN, SAGPool
from gnn_rul_tpu_torch.train import algorithms

import test_torch_model_checks as checks

METHOD = "HAGCN"


@pytest.fixture(scope="module")
def variables():
    return checks.jax_variables(METHOD)


@pytest.mark.parametrize("rows,swaps", [(4, 1), (10, 0)])
def test_eval_output_matches_jax(variables, rows, swaps):
    """The port replays the JAX forward's SAGPool choices and answers as JAX
    does. At 4 rows the fifth and sixth scores of one graph's second
    SAGPool lie 5e-8 apart (5e-7 of them): the port's own choice keeps the
    other node there (tests/test_torch_model_checks.py:swapped)."""
    assert checks.check_eval_forward(METHOD, variables, rows,
                                     seed=rows) == swaps


@pytest.mark.parametrize("tied", [False, True])
def test_sagpool_matches_jax_and_divides_kl_by_graphs(tied):
    """SAGPool alone on seeded (G, N, D) inputs: the kept nodes' features
    and adjacency and the KL, whose sum is divided by G (B * num_patch in
    HAGCN), not by B. Tied: every node has the same features and every
    adjacency row is the same, so all scores tie, and both packages keep
    nodes 0..4 (the kept adjacency's columns tell which)."""
    rng = np.random.default_rng(3)
    g, n, d = 6, 14, 16
    x = rng.normal(size=(g, n, d)).astype(np.float32)
    adj = rng.uniform(size=(g, n, n)).astype(np.float32)
    if tied:
        x[:] = x[:, :1]
        adj[:] = adj[:, :1]
    jpool = JaxSAGPool(8, 5)
    jvars = jpool.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(adj))
    want_x, want_a, want_kl = (np.asarray(v) for v in jpool.apply(
        jvars, jnp.asarray(x), jnp.asarray(adj)))
    pool = SAGPool(d, 8, 5)
    p = checks.numpy_tree(jvars["params"])
    with torch.no_grad():
        for name, lin in (("model", pool.model), ("rank", pool.rank),
                          ("mlp0", pool.mlp[0]), ("mlp1", pool.mlp[2])):
            lin.weight.copy_(torch.from_numpy(p[name]["Dense_0"]["kernel"].T))
            lin.bias.copy_(torch.from_numpy(p[name]["Dense_0"]["bias"]))
        got_x, got_a, got_kl = pool(torch.from_numpy(x), torch.from_numpy(adj))
    assert got_x.shape == (g, 5, 8) and got_a.shape == (g, 5, 5)
    np.testing.assert_allclose(got_x.numpy(), want_x, atol=2e-6, rtol=1e-5)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    if tied:
        np.testing.assert_array_equal(got_a.numpy(), adj[:, :5, :5])
    np.testing.assert_allclose(float(got_kl), float(want_kl), rtol=1e-5)
    with torch.no_grad():
        summed = pool(torch.from_numpy(np.concatenate([x, x])),
                      torch.from_numpy(np.concatenate([adj, adj])))[2]
    np.testing.assert_allclose(float(summed), float(got_kl), rtol=1e-5)


def test_train_mode_output_kl_and_gradients_match_jax(variables,
                                                      monkeypatch):
    """Train mode with dropout off on both sides: the prediction, the summed
    KL and the gradient of mean square + alpha * KL, every parameter against
    jax.grad (the recurrence's backward on the port's plain version)."""
    monkeypatch.setattr(checks.jax_basic.Dropout, "__call__",
                        lambda self, x, train=False: x)
    x = checks.x_rows(4, seed=0)
    jmodel = checks.jax_model(METHOD)

    def loss(params):
        out, kl = jmodel.apply({"params": params}, jnp.asarray(x), train=True,
                               rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean(out ** 2) + 100.0 * kl, (out, kl)

    (_, (want_out, want_kl)), want_grads = jax.value_and_grad(
        loss, has_aux=True)(variables["params"])
    model = checks.no_dropout(checks.port_model(METHOD, variables)).train()
    out, kl = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(kl.item(), float(want_kl), atol=2e-4,
                               rtol=1e-4)
    (torch.mean(out ** 2) + 100.0 * kl).backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    got = import_torch_state_dict(METHOD, grads, checks.hp(METHOD))["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(
        checks.numpy_tree(want_grads)))
    leaves = jax.tree_util.tree_leaves_with_path(checks.numpy_tree(got))
    assert len(leaves) == len(want)
    for path, leaf in leaves:
        np.testing.assert_allclose(leaf, want[path], atol=2e-4, rtol=1e-4,
                                   err_msg=str(path))


def test_weight_carry_round_trips_exactly(variables):
    checks.check_round_trip(METHOD, variables)


def test_five_adam_steps_match_jax(monkeypatch):
    """Five steps with the KL at the bank's alpha = 100 in the loss. The
    losses hold against JAX; the parameters end 1.7e-3 from JAX's, whose
    own fp32 run is 1.4e-3 off the same steps in fp64 against the port's
    3.7e-4, so the parameters hold against JAX in fp64
    (tests/test_torch_model_checks.py:hold)."""
    assert checks.TRAIN_PARAMS["alpha"] == 100
    assert checks.check_trajectory(METHOD, monkeypatch) == (
        "jax", "jax_fp64", 0.0)


def test_symbolic_artifact_matches_live_model(variables, tmp_path):
    """T = 14 * batch reaches the recurrence operator as an expression of
    the symbolic batch: the program holds its 3 calls, and the top-k
    gathers trace at that batch."""
    program = checks.check_symbolic_artifact(METHOD, variables, tmp_path)
    assert checks.op_nodes(program, "lstm_recurrence") == 3
    assert checks.our_op_nodes(program) == 3


def test_build_model_and_spec_resolve_hagcn():
    spec = algorithms.get_algorithm_spec(METHOD)
    assert spec.model_cls is HAGCN and spec.aux_weight == "alpha"
    assert spec.aux_weight == jalgorithms._TABLE[METHOD][2]["aux_weight"]
    model = checks.port_model(METHOD, checks.jax_variables(METHOD, seed=2))
    assert sorted({k.split(".")[0] for k in model.state_dict()}) == [
        "TD", "fc", "gin1", "gin2", "gin3", "gnn1", "gnn2", "gnn3"]
