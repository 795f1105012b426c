"""The port's signal front ends (gnn_rul_tpu_torch/signal/) and bearing
metrics against the JAX package's on the CPU, on seeded min-max scaled
signals (uniform in [0, 1)) at the patch sizes of the hparam bank.

``stft_magnitude`` and every feature stack are held at FEATURE_ATOL +
FEATURE_RTOL * |JAX|. The spectral features' median and peak bins are
step functions of the spectrum whose mirror pairs tie in exact math
(tests/test_torch_model_checks.py): the port's features are held with the
JAX package's bins replayed, and the bins where the port's own choice
differs are counted; each such pair has equal power."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu.configs import hparams as jhparams
from gnn_rul_tpu.signal import features as jfeatures
from gnn_rul_tpu.signal import stft as jstft
from gnn_rul_tpu.train import metrics as jmetrics
from gnn_rul_tpu_torch.signal import features, stft
from gnn_rul_tpu_torch.train import metrics

import test_torch_model_checks as checks

torch.set_num_threads(1)

FEATURE_ATOL, FEATURE_RTOL = 1e-5, 2e-5
BEARING_CELLS = [(d, f"Condition_{c}") for d in ("PHM2012", "XJTU_SY")
                 for c in (1, 2, 3)]


def _bank(methods, *keys):
    """The distinct values of ``keys`` in the bank's entries of
    ``methods`` at every bearing cell."""
    return sorted({tuple(jhparams.model_hparams(d, c, m)[k] for k in keys)
                   for d, c in BEARING_CELLS for m in methods})


STFT_SHAPES = _bank(("HierCorrPool_bearing", "STNet"), "patch_size",
                    "nperseg")
SAGCN_PATCHES = _bank(("SAGCN", "AGCN_TF"), "num_patch", "patch_size")
ST_GCN_PATCHES = [p for (p,) in _bank(("ST_GCN",), "patch_size")]
SED_SHAPES = _bank(("STMSGCN",), "patch_size", "interval", "band_width")


def signals(rows, length, seed):
    return np.random.default_rng(seed).uniform(
        size=(rows, length)).astype(np.float32)


def assert_close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=FEATURE_ATOL,
                               rtol=FEATURE_RTOL)


@pytest.mark.parametrize("patch,nperseg", STFT_SHAPES)
def test_stft_magnitude_matches_jax(patch, nperseg):
    x = signals(40, patch, seed=patch + nperseg)
    got = stft.stft_magnitude(torch.from_numpy(x), nperseg).numpy()
    want = np.asarray(jstft.stft_magnitude(jnp.asarray(x), nperseg))
    assert got.shape == want.shape == (40, nperseg // 2 + 1,
                                       1 + patch // nperseg)
    assert_close(got, want)


def test_stft_window_is_the_correctly_rounded_periodic_hann():
    for n in (8, 16, 32):
        np.testing.assert_array_equal(
            torch.hann_window(n, periodic=True, dtype=torch.float64)
            .float().numpy(),
            np.asarray(jstft.hann_window_periodic(n)))


@pytest.mark.parametrize("patch", sorted({p for _, p in SAGCN_PATCHES}
                                         | set(ST_GCN_PATCHES)))
@pytest.mark.parametrize("name", ["temporal_features_12", "st_gcn_features",
                                  "gat_lstm_features"])
def test_statistical_features_match_jax(name, patch):
    x = signals(64, patch, seed=patch)
    got = getattr(features, name)(torch.from_numpy(x)).numpy()
    assert_close(got, getattr(jfeatures, name)(jnp.asarray(x)))


def _replayed(name, x):
    """Feature stack ``name`` of the JAX package and of the port on ``x``,
    the port replaying the JAX call's bins; returns both outputs and how
    many of the port's own bins differ (each pair of equal power)."""
    own = []
    with pytest.MonkeyPatch.context() as mp:
        bins = checks.record_bins(mp)
        want = np.asarray(getattr(jfeatures, name)(jnp.asarray(x)))
        checks.replay(mp, features, bins, own, checks.replayed_indices)
        got = getattr(features, name)(torch.from_numpy(x)).numpy()
    assert len(own) == 2
    return got, want, checks.differing_bins(own, FEATURE_RTOL)


@pytest.mark.parametrize("patch", sorted({p for _, p in SAGCN_PATCHES}))
def test_frequency_features_match_jax_on_its_bins(patch):
    x = signals(512, patch, seed=patch + 1)
    got, want, differ = _replayed("frequency_features_8", x)
    assert_close(got, want)
    # Where the port's own median bin differs from the JAX call's, it is on
    # a pair of equal power (``differing_bins`` checks each); how many
    # differ depends on how the JAX package's CPU FFT rounds the pairs.
    print(f"patch {patch}: {differ} of 512 median bins differ from JAX")


@pytest.mark.parametrize("num_patch,patch", SAGCN_PATCHES)
def test_sagcn_features_match_jax(num_patch, patch):
    x = signals(3 * num_patch, patch, seed=num_patch).reshape(
        3, num_patch, patch)
    got, want, _ = _replayed("sagcn_features", x)
    assert got.shape == (3, num_patch, 40)
    assert_close(got, want)


def test_cumulative_features_match_jax():
    f = np.random.default_rng(0).normal(size=(3, 50, 20)).astype(np.float32)
    f[0, 0, 0] = 0.0  # a prefix sum of 0, at the clamp
    assert_close(features.cumulative_features(torch.from_numpy(f)).numpy(),
                 jfeatures.cumulative_features(jnp.asarray(f)))


@pytest.mark.parametrize("patch,interval,band_width", SED_SHAPES)
def test_sed_features_match_jax(patch, interval, band_width):
    x = signals(40, patch, seed=interval)
    got = features.sed_features(torch.from_numpy(x), interval,
                                band_width).numpy()
    want = jfeatures.sed_features(jnp.asarray(x), interval, band_width)
    assert got.shape == (40, (patch - interval) // band_width)
    assert_close(got, want)


@pytest.mark.parametrize("n", [16, 20, 64])
def test_torch_fft_ties_every_mirror_pair(n):
    """|X[k]| = |X[n - k]| bit for bit, so the port's own bins are the
    lower of a pair."""
    x = signals(256, n, seed=n)
    amp = torch.fft.fft(torch.from_numpy(x), dim=-1).abs()
    k = torch.arange(1, n)
    assert torch.equal(amp[:, k], amp[:, n - k])


def test_bin_selections_keep_the_first_of_equal_values():
    psd = torch.tensor([[3.0, 1.0, 2.0, 2.0, 1.0, 5.0]])
    assert features.median_bin(psd).tolist() == [3]
    assert features.peak_bin(torch.tensor([[1.0, 4.0, 4.0]])).tolist() == [1]


@pytest.mark.parametrize("name", ["calc_metrics_bearing",
                                  "calc_metrics_aeroengine"])
def test_metrics_match_jax(name):
    rng = np.random.default_rng(3)
    pred = rng.uniform(size=200).astype(np.float32)
    real = rng.uniform(size=200).astype(np.float32)
    got = getattr(metrics, name)(pred, real, 2803.0)
    want = getattr(jmetrics, name)(pred, real, 2803.0)
    assert len(got) == 3
    np.testing.assert_array_equal(got, want)
