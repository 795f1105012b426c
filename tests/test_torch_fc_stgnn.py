"""The port's FCSTGNN against the JAX package's at CMAPSS/FD001 full width:
the same weights (carried by gnn_rul_tpu_torch.compat.from_jax_variables),
the same seeded input, eval mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu.compat import import_torch_state_dict
from gnn_rul_tpu.configs import hparams
from gnn_rul_tpu.models.fc_stgnn import FCSTGNN as JaxFCSTGNN
from gnn_rul_tpu_torch.compat import from_jax_variables, jax_import
from gnn_rul_tpu_torch.models import MODELS
from gnn_rul_tpu_torch.models.fc_stgnn import FCSTGNN

torch.set_num_threads(1)

HP = hparams.model_hparams("CMAPSS", "FD001", "FC_STGNN")


def seeded_variables(seed=0):
    """JAX FCSTGNN variables with seeded nonzero BN means and positive
    variances, so that eval-mode BN is not the identity."""
    model = JaxFCSTGNN(**HP, fused="off")
    variables = model.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((2, 14, 50), jnp.float32), train=False)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    rng = np.random.default_rng(seed)

    def stat(path, a):
        if path[-1].key == "mean":
            return rng.normal(0.0, 0.5, a.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        stat, variables["batch_stats"])
    return variables


@pytest.fixture(scope="module")
def variables():
    return seeded_variables()


@pytest.fixture(scope="module")
def port(variables):
    model = FCSTGNN(**HP)
    model.load_state_dict(from_jax_variables("FC_STGNN", variables),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("fused", ["off", "on"])
def test_eval_output_matches_jax(variables, port, fused):
    x = np.random.default_rng(7).normal(size=(6, 14, 50)).astype(np.float32)
    want = np.asarray(JaxFCSTGNN(**HP, fused=fused).apply(
        variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (6, 1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_weight_carry_round_trips_exactly(variables, port):
    back = import_torch_state_dict("FC_STGNN", port.state_dict())
    want_leaves, want_tree = jax.tree_util.tree_flatten_with_path(variables)
    got_leaves, got_tree = jax.tree_util.tree_flatten_with_path(back)
    assert got_tree == want_tree
    for (path, want), (_, got) in zip(want_leaves, got_leaves):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))


def test_mask_and_pe_are_not_state():
    keys = FCSTGNN(**HP).state_dict().keys()
    assert not [k for k in keys if k.endswith(("mask", "pe"))]


def test_other_methods_raise_naming_roadmap(variables):
    """Every method of the reference has a layout; any other name raises."""
    assert set(jax_import._LAYOUTS) == set(MODELS)
    assert len(MODELS) == 21
    with pytest.raises(NotImplementedError, match="no method NoSuchMethod"):
        from_jax_variables("NoSuchMethod", variables)
