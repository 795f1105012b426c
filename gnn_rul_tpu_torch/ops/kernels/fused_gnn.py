"""Fused dot-graph chain: a hand-written CUDA kernel and its plain version.

    out = ((softmax(leaky_relu(h h^T - 1e8 I, 0.01)) + I) * mask) @ x

h ``(B, N, D)``, x ``(B, N, F)``, mask ``(N, N)`` -> ``(B, N, F)``, fp32.

Counterpart of ``gnn_rul_tpu/ops/pallas/fused_gnn.py`` (forward only; the
backward kernel belongs to the training slice). :data:`fused_dot_graph_spmm`
is the wrapper the model calls: on a CUDA tensor it launches the kernel in
``gnn_rul_tpu_torch/csrc/fused_gnn.cu`` or raises; on a CPU tensor it runs
:func:`fused_dot_graph_spmm_plain`.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/`` at the repository root, keyed by a hash of the source, and called
through ``ctypes`` on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "fused_gnn.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
MAX_FEAT = 128  # kMaxFeat in the source: the limit on D and on F
_ROWS_PER_BLOCK = 8  # kRowsPerBlock in the source


def fused_dot_graph_spmm_plain(h: torch.Tensor, x: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the chain, in the order of the JAX
    ``fused_dot_graph_spmm_reference``."""
    n = h.shape[-2]
    eye = torch.eye(n, dtype=h.dtype, device=h.device)
    s = torch.einsum("...nd,...md->...nm", h, h)
    s = F.leaky_relu(s - eye * 1e8, 0.01)
    a = torch.softmax(s, dim=-1) + eye
    a = a * mask
    return torch.einsum("...nm,...md->...nd", a, x)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the fused_gnn kernel is built from "
                       f"{SOURCE} with the CUDA toolkit")


def build_library() -> tuple[Path, str]:
    """Compile the source into ``build/`` unless a library of the same
    source hash is there. Returns ``(library path, nvcc's -Xptxas -v log)``;
    the log is empty when the library was already built."""
    src = SOURCE.read_bytes()
    lib = BUILD_DIR / f"fused_gnn_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def _check(h: torch.Tensor, x: torch.Tensor, mask: torch.Tensor) -> None:
    for name, t in (("h", h), ("x", x), ("mask", mask)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_dot_graph_spmm: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_dot_graph_spmm: {name} must be contiguous")
        if t.device != h.device:
            raise ValueError(f"fused_dot_graph_spmm: {name} is on {t.device}, "
                             f"h on {h.device}")
    if h.dim() != 3 or x.dim() != 3:
        raise ValueError(f"fused_dot_graph_spmm: h and x must be (B, N, D) and "
                         f"(B, N, F), got {tuple(h.shape)} and {tuple(x.shape)}")
    b, n, d = h.shape
    if x.shape[:2] != (b, n):
        raise ValueError(f"fused_dot_graph_spmm: x {tuple(x.shape)} does not "
                         f"match h {tuple(h.shape)}")
    if mask.shape != (n, n):
        raise ValueError(f"fused_dot_graph_spmm: mask must be one shared (N, N) "
                         f"= ({n}, {n}), got {tuple(mask.shape)}")
    if min(n, d, x.shape[2]) == 0:
        raise ValueError("fused_dot_graph_spmm: N, D and F must be nonzero")
    if d > MAX_FEAT or x.shape[2] > MAX_FEAT:
        raise ValueError(f"fused_dot_graph_spmm: D={d}, F={x.shape[2]}; the "
                         f"kernel takes D, F <= {MAX_FEAT}")
    if -(-n // _ROWS_PER_BLOCK) > 65535:
        raise ValueError(f"fused_dot_graph_spmm: N={n} exceeds the grid limit")


class FusedDotGraphSpmm:
    """The wrapper. ``launches`` counts kernel launches, nothing else."""

    def __init__(self) -> None:
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None

    def load(self) -> str:
        """Build (if needed) and load the library; returns the build log."""
        if self._lib is not None:
            return ""
        path, log = build_library()
        lib = ctypes.CDLL(str(path))
        lib.fused_dot_graph_spmm_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.fused_dot_graph_spmm_fwd.restype = ctypes.c_int
        lib.fused_dot_graph_spmm_error_string.argtypes = [ctypes.c_int]
        lib.fused_dot_graph_spmm_error_string.restype = ctypes.c_char_p
        lib.fused_dot_graph_spmm_max_feat.argtypes = []
        lib.fused_dot_graph_spmm_max_feat.restype = ctypes.c_int
        if lib.fused_dot_graph_spmm_max_feat() != MAX_FEAT:
            raise RuntimeError(f"{path}: kernel limit differs from MAX_FEAT")
        self._lib = lib
        return log

    def __call__(self, h: torch.Tensor, x: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        _check(h, x, mask)
        if h.device.type == "cpu":
            return fused_dot_graph_spmm_plain(h, x, mask)
        if h.device.type != "cuda":
            raise ValueError(f"fused_dot_graph_spmm: no kernel for {h.device}")
        if h.requires_grad or x.requires_grad or mask.requires_grad:
            raise NotImplementedError(
                "fused_dot_graph_spmm: no backward kernel yet (training "
                "slice, ROADMAP.md); run under torch.inference_mode()")
        self.load()
        b, n, d = h.shape
        f = x.shape[2]
        out = torch.empty((b, n, f), dtype=x.dtype, device=x.device)
        if b == 0:
            return out
        with torch.cuda.device(h.device):
            stream = torch.cuda.current_stream(h.device).cuda_stream
            err = self._lib.fused_dot_graph_spmm_fwd(
                h.data_ptr(), x.data_ptr(), mask.data_ptr(), out.data_ptr(),
                b, n, d, f, stream)
        if err != 0:
            msg = self._lib.fused_dot_graph_spmm_error_string(err).decode()
            raise RuntimeError(f"fused_dot_graph_spmm launch failed "
                               f"(B={b}, N={n}, D={d}, F={f}): {msg}")
        self.launches += 1
        return out


fused_dot_graph_spmm = FusedDotGraphSpmm()
