"""Keyed dropout: a hand-written CUDA kernel and its plain version.

    out = keep(key, call, offset + e) ? x / (1 - p) : 0

The keep mask is a pure function of an int64 key, the dropout call's number
``call`` in its forward and each element's index ``offset + e``
(``offset`` 0, or under the data axis the global index of this rank's
first element, ``nn/basic.py``): splitmix64's
finaliser of ``key + call * golden`` keys the call, and element e is kept
where the top 24 bits of ``mix(call key + e * golden)`` reach ``p * 2^24``
(:func:`keep_mask`, in int64 tensor ops with the right shifts masked, since
torch's int64 ``>>`` is arithmetic). So the mask is the same bits on the CPU
and on the card. key is a scalar, or ``(G,)`` with G dividing x's elements:
group g's slice of x, the g-th of G equal ones, takes ``key[g]`` and counts
its elements from 0. Under ``torch.func.vmap`` its rule folds the
seeds into those groups, so each seed draws its sequential run's mask, all
seeds in one launch. x is fp32 or bf16 (the division in fp32, the output
rounded once).

:data:`keyed_dropout` is the wrapper ``nn/basic.py::Dropout`` calls. It runs
an ``autograd.Function`` with a vmap rule that takes, by the device of x,
:func:`keyed_dropout_plain` on the CPU and the kernel in
``gnn_rul_tpu_torch/csrc/keyed_dropout.cu`` on CUDA (or raises). The
operator is linear in x with the same mask for its gradient, so its
backward is the operator again on the gradient (a second launch on CUDA).
The kernel is
compiled with ``nvcc`` for ``sm_90a`` at its first launch
(``ops/kernels/build.py``), never at import, and called through ``ctypes``
on PyTorch's current stream.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import torch

from ...telemetry import span
from .build import build_libraries

MASK64 = (1 << 64) - 1
GOLDEN = 0x9E3779B97F4A7C15
_MIX1, _MIX2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB
DTYPES = (torch.float32, torch.bfloat16)  # the kernel's instantiations


def signed(v: int) -> int:
    """A 64-bit pattern as the int64 that holds it."""
    v &= MASK64
    return v - (1 << 64) if v >> 63 else v


def mix_int(z: int) -> int:
    """splitmix64's finaliser on a Python int (64-bit wrapping)."""
    z &= MASK64
    z = ((z ^ (z >> 30)) * _MIX1) & MASK64
    z = ((z ^ (z >> 27)) * _MIX2) & MASK64
    return z ^ (z >> 31)


def _srl(z: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 ``z``: torch's ``>>`` is arithmetic,
    so the sign bits it brings in are masked off."""
    return (z >> n) & ((1 << (64 - n)) - 1)


def mix(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser on int64 tensors; the products wrap."""
    z = (z ^ _srl(z, 30)) * signed(_MIX1)
    z = (z ^ _srl(z, 27)) * signed(_MIX2)
    return z ^ _srl(z, 31)


def threshold(p: float) -> int:
    """The kept elements' least top 24 bits."""
    return round(p * (1 << 24))


def _keep(keys: torch.Tensor, n: int, p: float,
          offset: int = 0) -> torch.Tensor:
    """``(G, n)`` keep masks, one a call key of ``keys (G, 1)``, of the
    elements ``offset .. offset + n - 1``."""
    idx = torch.arange(offset, offset + n, dtype=torch.int64,
                       device=keys.device)
    return _srl(mix(keys + idx * signed(GOLDEN)), 40) >= threshold(p)


def keep_mask(key: torch.Tensor, shape, p: float,
              device: torch.device) -> torch.Tensor:
    """The keep mask of ``shape`` for a call's key (an int64 scalar tensor,
    the call already mixed in): element e is kept where the top 24 bits of
    ``mix(key + e * golden)`` reach ``p * 2^24``, so with probability
    1 - p."""
    n = 1
    for s in shape:
        n *= int(s)
    return _keep(key.to(device).reshape(1, 1), n, p).reshape(shape)


def call_key(key: torch.Tensor, call: int) -> torch.Tensor:
    """The key of a forward's ``call``-th dropout: ``mix(key + call *
    golden)``."""
    return mix(key + signed(call * GOLDEN))


def keyed_dropout_plain(x: torch.Tensor, key: torch.Tensor, call: int,
                        p: float, offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version: the mask in int64 tensor ops, ``x / (1 - p)``
    where kept (bf16 divided in fp32 and rounded once), else 0."""
    g = key.numel()
    keys = call_key(key.reshape(g, 1).to(x.device), call)
    keep = _keep(keys, x.numel() // g, p, offset).reshape(x.shape)
    scaled = x.float() / (1.0 - p)
    return torch.where(keep, scaled, torch.zeros_like(scaled)).to(x.dtype)


def _check(x: torch.Tensor, key: torch.Tensor, p: float,
           offset: int = 0) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"keyed_dropout: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if key.dtype != torch.int64 or key.dim() > 1:
        raise TypeError(f"keyed_dropout: key must be an int64 scalar or "
                        f"(G,), got {key.dtype} {tuple(key.shape)}")
    if key.numel() == 0 or x.numel() % key.numel():
        raise ValueError(f"keyed_dropout: {key.numel()} keys do not divide "
                         f"x's {x.numel()} elements")
    if key.device != x.device:
        raise ValueError(f"keyed_dropout: key is on {key.device}, x on "
                         f"{x.device}")
    if not 0.0 <= p < 1.0:
        raise ValueError(f"keyed_dropout: p must be in [0, 1), got {p}")
    if offset < 0:
        raise ValueError(f"keyed_dropout: offset must be >= 0, got {offset}")
    if not x.is_contiguous():
        raise ValueError("keyed_dropout: x must be contiguous")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"keyed_dropout: no kernel for {x.device}")


def _apply(x: torch.Tensor, key: torch.Tensor, call: int, p: float,
           offset: int = 0) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on any other."""
    _check(x, key, p, offset)
    if x.device.type == "cuda":
        return keyed_dropout.forward(x, key, call, p, offset)
    return keyed_dropout_plain(x, key, call, p, offset)


class _KeyedDropout(torch.autograd.Function):
    """The operator: linear in x, the same mask and scale on its
    gradient, so its backward is the operator again. An
    ``autograd.Function`` rather than a registered operator: a training
    step calls it up to 10 times (STFA), and through a registered
    operator STFA's step took 18.2 ms against 14.5 ms through
    ``F.dropout`` (H100 80GB HBM3, 700 W), the operator's Python dispatch
    and autograd costing more a call than the kernel. It is never
    exported: serving runs in eval mode, where Dropout is the identity."""

    @staticmethod
    def forward(x, key, call, p, offset):
        return _apply(x, key, call, p, offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, key, ctx.call, ctx.p, ctx.offset = inputs
        ctx.save_for_backward(key)

    @staticmethod
    def backward(ctx, g):
        key, = ctx.saved_tensors
        return (_apply(g.contiguous(), key, ctx.call, ctx.p, ctx.offset),
                None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, x, key, call, p, offset):
        """Each seed's x a slice of one call, its key (or keys, where the
        key was grouped already) that slice's: seed s, group g becomes
        group ``s * G + g``. An unmapped key is every seed's."""
        s = info.batch_size
        xd, kd = in_dims[:2]
        x = x.expand(s, *x.shape) if xd is None else x.movedim(xd, 0)
        keys = (key.reshape(-1).repeat(s) if kd is None
                else key.movedim(kd, 0).reshape(-1))
        return _KeyedDropout.apply(x.contiguous(), keys.contiguous(), call,
                                   p, offset), 0


class KeyedDropout:
    """The wrapper. ``launches`` counts launches of the kernel at either
    dtype, forward and backward alike (the backward is the forward on the
    gradient), and ``bf16_launches`` the bf16 instantiation's share;
    nothing else adds to them."""

    def __init__(self) -> None:
        self.launches = 0
        self.bf16_launches = 0
        self._lib: Optional[ctypes.CDLL] = None

    def load(self) -> str:
        """Build (if needed) and load the library; returns nvcc's log of the
        sources built by this call."""
        if self._lib is not None:
            return ""
        with span("kernels.load.keyed_dropout", first=True):
            return self._open()

    def _open(self) -> str:
        built = build_libraries()
        lib = ctypes.CDLL(str(built["keyed_dropout"][0]))
        for fn in (lib.keyed_dropout_fwd, lib.keyed_dropout_fwd_bf16):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_float, ctypes.c_uint,
                           ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_longlong,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.keyed_dropout_error_string.argtypes = [ctypes.c_int]
        lib.keyed_dropout_error_string.restype = ctypes.c_char_p
        self._lib = lib
        return "".join(log for _, log in built.values())

    def __call__(self, x: torch.Tensor, key: torch.Tensor, call: int,
                 p: float, offset: int = 0) -> torch.Tensor:
        if not isinstance(key, torch.Tensor):
            raise TypeError(f"keyed_dropout: key must be a tensor, got "
                            f"{type(key).__name__}")
        return _KeyedDropout.apply(x.contiguous(), key.to(x.device),
                                   int(call), float(p), int(offset))

    def forward(self, x: torch.Tensor, key: torch.Tensor, call: int,
                p: float, offset: int = 0) -> torch.Tensor:
        """The kernel alone, on CUDA tensors that :func:`_check` accepts:
        one launch for all the groups, without autograd."""
        if x.device.type != "cuda":
            raise ValueError(f"keyed_dropout: the kernel runs on CUDA "
                             f"tensors, got {x.device}")
        self.load()
        out = torch.empty_like(x)
        if x.numel() == 0:
            return out
        g = key.numel()
        bf16 = x.dtype == torch.bfloat16
        entry = self._lib.keyed_dropout_fwd_bf16 if bf16 else \
            self._lib.keyed_dropout_fwd
        # The device's context only where it is not current: a training
        # step makes up to 20 of these calls.
        here = (contextlib.nullcontext()
                if x.device.index == torch.cuda.current_device()
                else torch.cuda.device(x.device))
        with here:
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = entry(x.data_ptr(), key.contiguous().data_ptr(), int(call),
                        1.0 - p, threshold(p), out.data_ptr(),
                        x.numel() // g, g, int(offset), stream)
        if err != 0:
            msg = self._lib.keyed_dropout_error_string(err).decode()
            raise RuntimeError(f"keyed_dropout launch failed ({x.numel()} "
                               f"elements, {g} keys): {msg}")
        self.launches += 1
        self.bf16_launches += bf16
        return out


keyed_dropout = KeyedDropout()
