"""The bearing front ends' STFT magnitude (counterpart of
``gnn_rul_tpu/signal/stft.py``).

Every bearing front end of the reference calls ``torch.stft(x, n_fft=hop=
win=nperseg, window=hann(periodic), return_complex=True)`` and takes the
magnitude (e.g. models/STNet/Model.py:93-102), with torch's defaults
``center=True`` (reflect-padded by nperseg // 2 on each side) and
``onesided=True``: ``nperseg // 2 + 1`` bins and ``1 + L // nperseg``
frames. The JAX package rebuilds that call from strided frames and an rFFT;
the port makes the call itself, which on the card is cuFFT (the JAX
package's is an XLA FFT, no Pallas kernel). An FFT takes no bfloat16, so
under ``--precision bf16`` the transform runs in fp32 on the bf16 signal
(the window rounded to bf16, as the JAX package forms it in the input's
dtype) and the magnitude is rounded back to bf16, as ``jnp.fft`` does it.
"""

from __future__ import annotations

import torch


def stft_magnitude(x: torch.Tensor, nperseg: int) -> torch.Tensor:
    """|STFT| of ``(B, L)`` signals -> ``(B, nperseg // 2 + 1, 1 + L //
    nperseg)``."""
    # Formed in float64 and rounded once: torch's float32 window is up to
    # an ulp off the correctly rounded one (the JAX package's).
    window = torch.hann_window(nperseg, periodic=True, dtype=torch.float64,
                               device=x.device).to(x.dtype)
    return torch.stft(fft_input(x), n_fft=nperseg, hop_length=nperseg,
                      win_length=nperseg, window=fft_input(window),
                      center=True, pad_mode="reflect", onesided=True,
                      return_complex=True).abs().to(x.dtype)


def fft_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` as an FFT takes it: a bfloat16 tensor in fp32, any other as it
    is."""
    return x.float() if x.dtype == torch.bfloat16 else x
