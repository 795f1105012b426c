"""The port's serving entry point (gnn_rul_tpu_torch.export) against the JAX
package's exported serving artifact on the same weights."""

import numpy as np
import pytest
import torch
from jax import export as jexport

from gnn_rul_tpu.configs import hparams
from gnn_rul_tpu.export import ServingModel as JaxServingModel
from gnn_rul_tpu.export import export_serving
from gnn_rul_tpu_torch.compat import from_jax_variables
from gnn_rul_tpu_torch.export import serving_model

from test_torch_fc_stgnn import seeded_variables

torch.set_num_threads(1)

HP = hparams.model_hparams("CMAPSS", "FD001", "FC_STGNN")


@pytest.fixture(scope="module")
def variables():
    return seeded_variables(seed=3)


def _jax_serving(variables, batch_size):
    meta, blob = export_serving("FC_STGNN", "CMAPSS", "FD001", variables,
                                batch_size=batch_size, platforms=("cpu",),
                                model_hparams=HP)
    return JaxServingModel(meta, jexport.deserialize(bytearray(blob)))


@pytest.mark.parametrize("batch_size,rows", [(4, 6), (4, 4), (None, 5)])
def test_serving_matches_jax_artifact(variables, batch_size, rows):
    want_model = _jax_serving(variables, batch_size)
    got_model = serving_model("FC_STGNN", "CMAPSS", "FD001",
                              from_jax_variables("FC_STGNN", variables),
                              batch_size=batch_size, device="cpu")
    assert got_model.meta["input_shape"] == want_model.meta["input_shape"]
    x = np.random.default_rng(rows).normal(
        size=(rows, 14, 50)).astype(np.float32)
    got = got_model(x)
    assert got.shape == (rows,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_model(x), atol=2e-4, rtol=1e-4)


def test_reference_model_dict_with_algorithm_prefix(variables):
    sd = from_jax_variables("FC_STGNN", variables)
    x = np.random.default_rng(0).normal(size=(3, 14, 50)).astype(np.float32)
    plain = serving_model("FC_STGNN", "CMAPSS", "FD001", sd, device="cpu")
    prefixed = serving_model("FC_STGNN", "CMAPSS", "FD001",
                             {f"model.{k}": v for k, v in sd.items()},
                             device="cpu")
    np.testing.assert_array_equal(prefixed(x), plain(x))


def test_wrong_shape_raises(variables):
    model = serving_model("FC_STGNN", "CMAPSS", "FD001",
                          from_jax_variables("FC_STGNN", variables),
                          batch_size=4, device="cpu")
    x = np.zeros((6, 14, 50), np.float32)
    for bad in (x[:, :3], x[:, :, :49], x[0]):
        with pytest.raises(ValueError):
            model(bad)


def test_default_device_without_cuda_raises(variables, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving_model("FC_STGNN", "CMAPSS", "FD001",
                      from_jax_variables("FC_STGNN", variables))
