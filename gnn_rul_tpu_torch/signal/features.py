"""Handcrafted statistical and spectral feature stacks of the bearing front
ends (counterpart of ``gnn_rul_tpu/signal/features.py``):

  - ``sagcn_features`` (40 a patch): reference models/SAGCN/Model.py:7-72,
    12 temporal + 8 spectral + their 20 cumulative forms, L2-normalised
    over (patch, feature) per sample;
  - ``st_gcn_features`` (10): models/ST_GCN/Model.py:7-52;
  - ``gat_lstm_features`` (11): models/GAT_LSTM/Model.py:8-72;
  - ``sed_features``: models/STMSGCN/Model.py:7-31.

Standard deviation and variance are unbiased (torch's ``correction=1``).
The reference's O(L^2) cumulative loop is one cumsum, as in the JAX
package: position p only reads the prefix sum ending at p.

Two of the spectral features select a bin: the median frequency (the bin
at position n // 2 of the power spectrum sorted ascending, by a stable
sort) and the frequency of the largest amplitude (the first largest).
The FFT of a real signal has ``|X[k]| = |X[n - k]|``: torch's FFT fills
the upper half by that symmetry, so the pair ties exactly and the lower
bin wins, while a complex FFT (the JAX package's) parts the pair by
rounding and either can win. The two bins are ``+f`` and ``-f``. Both
selections are module functions (:func:`median_bin`, :func:`peak_bin`),
so a caller can replay another implementation's choices.
"""

from __future__ import annotations

import torch

from .stft import fft_input


def _std_unbiased(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.sqrt(_var_unbiased(x, dim))


def _var_unbiased(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    n = x.shape[dim]
    mean = torch.mean(x, dim=dim, keepdim=True)
    return torch.sum((x - mean) ** 2, dim=dim) / (n - 1)


def temporal_features_12(x: torch.Tensor) -> torch.Tensor:
    """``(B, L)`` -> ``(B, 12)``: reference models/SAGCN/Model.py:21-38."""
    max_v = torch.amax(x, dim=-1)
    min_v = torch.amin(x, dim=-1)
    std_v = _std_unbiased(x)
    rms_v = torch.sqrt(torch.mean(x * x, dim=-1))
    mean_v = torch.mean(x, dim=-1)
    ptp_v = max_v - min_v
    var_v = _var_unbiased(x)
    logp = torch.log_softmax(x, dim=-1)
    entropy = -torch.sum(torch.exp(logp) * logp, dim=-1)
    asin_v = _std_unbiased(torch.asin(torch.clamp(x, -1 + 1e-7, 1 - 1e-7)))
    atan_v = _std_unbiased(torch.atan(x))
    centered = x - mean_v[..., None]
    kurt = torch.mean(centered ** 4, dim=-1) / (std_v ** 4) - 3.0
    skew = torch.mean(centered ** 3, dim=-1) / (std_v ** 3)
    return torch.stack([max_v, min_v, std_v, rms_v, mean_v, ptp_v, var_v,
                        entropy, asin_v, atan_v, kurt, skew], dim=-1)


def median_bin(psd: torch.Tensor) -> torch.Tensor:
    """The bin at position n // 2 of each row of ``psd (R, n)`` sorted
    ascending, equal values in the order of their bins."""
    return torch.argsort(psd, dim=-1, stable=True)[:, psd.shape[-1] // 2]


def peak_bin(amp: torch.Tensor) -> torch.Tensor:
    """The first bin of each row's largest amplitude."""
    return torch.argmax(amp, dim=-1)


def frequency_features_8(x: torch.Tensor) -> torch.Tensor:
    """``(B, L)`` -> ``(B, 8)``: reference models/SAGCN/Model.py:41-57, at a
    sampling rate of 1."""
    n = x.shape[-1]
    # ``np.fft.fftfreq(n)`` rounded to x's dtype, formed on x's device.
    freqs = torch.fft.fftfreq(n, dtype=torch.float64,
                              device=x.device).to(x.dtype)
    amp = torch.fft.fft(fft_input(x), dim=-1).abs().to(x.dtype)
    psd = amp * amp / n

    psd_sum = torch.sum(psd, dim=-1)
    mean_freq = torch.sum(freqs * psd, dim=-1) / psd_sum
    median_freq = freqs[median_bin(psd)]
    band_power = psd_sum
    occupied_bw = torch.sum(psd * (freqs < 0.5), dim=-1) / psd_sum
    power_bw = torch.sqrt(torch.sum(psd * psd, dim=-1) / psd_sum)
    max_psd = torch.amax(psd, dim=-1)
    max_amp = torch.amax(amp, dim=-1)
    freq_max_amp = freqs[peak_bin(amp)]
    return torch.stack([mean_freq, median_freq, band_power, occupied_bw,
                        power_bw, max_psd, max_amp, freq_max_amp], dim=-1)


def cumulative_features(feats: torch.Tensor) -> torch.Tensor:
    """``(B, L, f)`` -> ``(B, L, f)``: ``c_p / sqrt(clamp(|c_p|, 1e-12))``
    with ``c`` the cumsum over L (models/SAGCN/Model.py:7-19)."""
    c = torch.cumsum(feats, dim=1)
    return c / torch.sqrt(torch.clamp(torch.abs(c), min=1e-12))


def sagcn_features(x: torch.Tensor) -> torch.Tensor:
    """``(B, num_patch, patch_size)`` -> ``(B, num_patch, 40)``,
    L2-normalised over (patch, feature) per sample
    (models/SAGCN/Model.py:60-72)."""
    b, t, p = x.shape
    flat = x.reshape(b * t, p)
    feats = torch.cat([temporal_features_12(flat),
                       frequency_features_8(flat)], dim=-1)
    feats = feats.reshape(b, t, -1)
    feats = torch.cat([feats, cumulative_features(feats)], dim=-1)
    norm = torch.sqrt(torch.sum(feats * feats, dim=(1, 2), keepdim=True))
    return feats / norm


def st_gcn_features(x: torch.Tensor) -> torch.Tensor:
    """``(B, L)`` -> ``(B, 10)``: reference models/ST_GCN/Model.py:7-52."""
    max_v = torch.amax(x, dim=1)
    min_v = torch.amin(x, dim=1)
    ptp_v = max_v - min_v
    var_v = _var_unbiased(x, dim=1)
    std_v = _std_unbiased(x, dim=1)
    mean_v = torch.mean(x, dim=1)
    rms_v = torch.sqrt(torch.mean(x * x, dim=1))
    mean_abs = torch.mean(torch.abs(x), dim=1)
    z = (x - mean_v[..., None]) / std_v[..., None]
    skew_v = torch.mean(z ** 3, dim=1)
    kurt_v = torch.mean(z ** 4, dim=1) - 3.0
    return torch.stack([max_v, min_v, ptp_v, var_v, std_v, mean_v, rms_v,
                        mean_abs, skew_v, kurt_v], dim=-1)


def gat_lstm_features(x: torch.Tensor) -> torch.Tensor:
    """``(B, m)`` -> ``(B, 11)``: reference models/GAT_LSTM/Model.py:8-72,
    its skewness and kurtosis coefficients included."""
    m = x.shape[-1]
    mean_v = torch.mean(x, dim=-1)
    std_v = _std_unbiased(x)
    rms_amp = torch.mean(torch.sqrt(torch.abs(x)), dim=-1) ** 2
    rms_v = torch.sqrt(torch.mean(x * x, dim=-1))
    ptp_v = 0.5 * (torch.amax(x, dim=-1) - torch.amin(x, dim=-1))
    diff = x - mean_v[..., None]
    skew_c = m / ((m - 1) * (m - 2))
    skew_v = skew_c * torch.sum(diff ** 3, dim=-1) / (std_v ** 3)
    kurt_c = (m * (m + 1) - 3 * (m - 1) ** 3) / ((m - 1) * (m - 2) * (m - 3))
    kurt_v = kurt_c * torch.sum(diff ** 4, dim=-1) / (std_v ** 4)
    abs_max = torch.amax(torch.abs(x), dim=-1)
    mean_abs = torch.mean(torch.abs(x), dim=-1)
    crest = abs_max / rms_v
    clearance = abs_max / rms_amp
    shape_f = rms_v / mean_abs
    impulse = abs_max / mean_abs
    return torch.stack([mean_v, std_v, rms_amp, rms_v, ptp_v, skew_v, kurt_v,
                        crest, clearance, shape_f, impulse], dim=-1)


def sed_features(x: torch.Tensor, interval: int, band_width: int
                 ) -> torch.Tensor:
    """Spectral energy difference ``(B, L)`` -> ``(B, (L - interval) //
    band_width)``: reference models/STMSGCN/Model.py:7-31."""
    b = x.shape[0]
    spec = torch.fft.fft(fft_input(x), dim=-1)
    sd = spec[:, interval:] - spec[:, :-interval]
    sq = (sd.real ** 2 + sd.imag ** 2).to(x.dtype)
    return torch.sum(sq.reshape(b, -1, band_width), dim=-1)
