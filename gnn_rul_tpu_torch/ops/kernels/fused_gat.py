"""Fused dense graph attention: a hand-written CUDA kernel and its plain
version.

    e_ij = leaky_relu(f1_i + f2_j + bias, slope)
    out  = (softmax_j(e) * adj) @ wh

wh ``(B, N, D)``, f1 and f2 ``(B, N)``, adj ``(B, N, N)`` or one ``(N, N)``
shared by every graph, bias a one-element tensor, slope a float ->
``(B, N, D)``, all fp32, or all bf16 (``--precision bf16``: read in bf16,
the softmax's statistics and the products in fp32, the output rounded once
to bf16, as the Pallas kernel computes it). For seed-parallel runs
(``train/vectorized.py``) adj may also be ``(A, N, N)`` and bias
``(G,)``, with A and G dividing B: the batch is then A (or G) equal
groups of graphs, group a's graphs on
``adj[a]`` (group g's with ``bias[g]``). adj ``(B, N, N)`` is the case A =
B; one bias and an ``(N, N)`` adj are the one call of before, on the same
plans. Under ``torch.func.vmap`` the operator's rule folds the seeds into
B and a mapped bias or shared adj into their groups, so all seeds run in
one launch (``batching.py``).

Counterpart of ``gnn_rul_tpu/ops/pallas/fused_gat.py``. :data:`fused_gat`
is the wrapper ``nn/attention.py`` calls. It calls the registered operator
``gnn_rul_tpu_torch::fused_gat(wh, f1, f2, adj, bias, slope) -> out``,
whose implementation PyTorch's dispatcher picks by the device of the
tensors when the call runs: on the CPU :func:`fused_gat_plain`, at any N;
on CUDA the kernel in ``gnn_rul_tpu_torch/csrc/fused_gat.cu`` (its plan
for (B, N, D): :func:`gat_plan`; N up to :data:`MAX_N`) or it raises; on
any other device it raises. A shape-only fake implementation lets
``torch.export`` trace the operator into a program at a symbolic batch.
The operator's autograd formula saves wh, f1, f2, adj and bias and
recomputes through :func:`fused_gat_plain`, as the JAX ``_bwd`` recomputes
through ``fused_gat_reference``: the TPU kernel has no backward, and
neither has this one. bias is a tensor so that it gets its gradient.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at its first launch
(``ops/kernels/build.py``), never at import, and called through ``ctypes``
on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .batching import fold, groups, unfold
from .build import build_libraries

_TARGET_BLOCKS = 132  # kTargetBlocks in the source: an H100's SMs
_WORK_PER_BLOCK = 2048  # kWorkPerBlock: pairs or outputs a block
_BUDGET = 48 * 1024 // 4  # kBudget: shared floats a block
MAX_N = 3069  # the largest N whose one row and one wh column fit _BUDGET
DTYPES = (torch.float32, torch.bfloat16)  # the kernel's instantiations


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _floats(n: int, g: int, r: int, c: int) -> int:
    # floats() in the source: f2, f1, the weight tile at quad_stride(N),
    # the adj rows and the (round4(N), c) wh chunk
    return g * (n + r + r * (4 * ((n + 3) // 4 | 1) + n) + _round4(n) * c)


def gat_plan(b: int, n: int, d: int, part: Optional[int] = None) -> dict:
    """The kernel's plan for (B, N, D), as ``csrc/fused_gat.cu`` chooses
    it: whole graphs a block (``graphs``) from B = 132 on, else a tile of
    ``rows`` of one graph a block, spread over ``row_tiles`` blocks a
    graph; wh in chunks of ``cols`` columns; ``blocks`` and ``smem`` (bytes
    a block). A block of whole graphs holds graphs of one ``part`` only
    (the consecutive graphs that share one bias and, for a grouped adj,
    one adj, as ``csrc/fused_gat.cu`` cuts them; all B when None): the
    most graphs, up to the ungrouped plan's, that divide a part's."""
    part = b if part is None else part
    if min(b, n, d, part) <= 0 or n > MAX_N or b % part:
        raise ValueError(f"fused_gat: no plan for B={b}, N={n}, D={d}")
    work = n * max(n, d)
    whole = _floats(n, 1, n, d)
    if b >= _TARGET_BLOCKS and whole <= _BUDGET:
        g = max(1, min(_WORK_PER_BLOCK // work, _BUDGET // whole,
                       b // _TARGET_BLOCKS))
        while part < b and part % g:
            g -= 1
        return {"graphs": g, "rows": n, "cols": d, "row_tiles": 1,
                "blocks": -(-b // g), "smem": 4 * _floats(n, g, n, d)}
    tiles = min(n, -(-_TARGET_BLOCKS // b))
    rows, cols = -(-n // tiles), d
    while rows > 1 and _floats(n, 1, rows, cols) > _BUDGET:
        rows = (rows + 1) // 2
    if _floats(n, 1, rows, cols) > _BUDGET:
        cols = (_BUDGET - _floats(n, 1, rows, 0)) // _round4(n)
        if cols >= 4:
            cols -= cols % 4
    row_tiles = -(-n // rows)
    return {"graphs": 1, "rows": rows, "cols": cols, "row_tiles": row_tiles,
            "blocks": b * row_tiles, "smem": 4 * _floats(n, 1, rows, cols)}


def adj_groups(adj: torch.Tensor) -> int:
    """A in adj ``(A, N, N)``; 1 for one ``(N, N)`` shared by every graph."""
    return 1 if adj.dim() == 2 else adj.shape[0]


def _per_graph(t: torch.Tensor, b: int) -> torch.Tensor:
    """A grouped ``(K, ...)`` repeated for each graph of its group."""
    return t.repeat_interleave(b // t.shape[0], dim=0)


def fused_gat_plain(wh: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                    adj: torch.Tensor, bias: torch.Tensor,
                    slope: float) -> torch.Tensor:
    """Plain PyTorch version, in the order of the JAX
    ``fused_gat_reference``; a grouped bias or adj applies to each graph of
    its group. bf16 operands are computed on in fp32 and the output
    rounded once to bf16."""
    dtype = wh.dtype
    if dtype == torch.bfloat16:
        wh, f1, f2, adj, bias = (t.float() for t in (wh, f1, f2, adj, bias))
    b = wh.shape[0]
    if adj.dim() == 3 and adj.shape[0] != b:
        adj = _per_graph(adj, b)
    if bias.numel() == 1:
        return _attend(wh, f1, f2, adj, bias, slope).to(dtype)
    g = bias.shape[0]
    grouped = (t.unflatten(0, (g, -1)) for t in (wh, f1, f2))
    if adj.dim() == 3:
        adj = adj.unflatten(0, (g, -1))
    return _attend(*grouped, adj, bias[:, None, None, None],
                   slope).flatten(0, 1).to(dtype)


def _attend(wh, f1, f2, adj, bias, slope):
    e = f1[..., :, None] + f2[..., None, :] + bias
    e = F.leaky_relu(e, slope)
    attn = torch.softmax(e, dim=-1) * adj
    return torch.einsum("...nm,...md->...nd", attn, wh)


def _check(wh: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
           adj: torch.Tensor, bias: torch.Tensor) -> None:
    named = (("wh", wh), ("f1", f1), ("f2", f2), ("adj", adj), ("bias", bias))
    if wh.dtype not in DTYPES:
        raise TypeError(f"fused_gat: wh must be float32 or bfloat16, got "
                        f"{wh.dtype}")
    for name, t in named:
        if t.dtype != wh.dtype:
            raise TypeError(f"fused_gat: {name} is {t.dtype}, wh {wh.dtype}; "
                            f"every tensor takes one dtype")
        if not t.is_contiguous():
            raise ValueError(f"fused_gat: {name} must be contiguous")
        if t.device != wh.device:
            raise ValueError(f"fused_gat: {name} is on {t.device}, wh on "
                             f"{wh.device}")
    if wh.dim() != 3:
        raise ValueError(f"fused_gat: wh must be (B, N, D), got "
                         f"{tuple(wh.shape)}")
    b, n, d = wh.shape
    if f1.shape != (b, n) or f2.shape != (b, n):
        raise ValueError(f"fused_gat: f1 {tuple(f1.shape)} and f2 "
                         f"{tuple(f2.shape)} must be (B, N) = ({b}, {n})")
    # The rank first: comparing a (B, N, N) shape with (N, N) element by
    # element would compare a symbolic B with N and pin it; and a per-graph
    # adj before the groups, so a symbolic B is not divided.
    if not ((adj.dim() == 2 and adj.shape == (n, n))
            or (adj.dim() == 3 and adj.shape == (b, n, n))
            or (adj.dim() == 3 and adj.shape[1:] == (n, n)
                and adj.shape[0] > 0 and b % adj.shape[0] == 0)):
        raise ValueError(f"fused_gat: adj must be (N, N), (B, N, N) or (A, N, "
                         f"N) with A dividing B={b}, N={n}, got "
                         f"{tuple(adj.shape)}")
    if bias.numel() != 1 and (bias.dim() != 1 or b % bias.shape[0]):
        raise ValueError(f"fused_gat: bias must hold one value or be (G,) "
                         f"with G dividing B={b}, got {tuple(bias.shape)}")
    if min(n, d) == 0:
        raise ValueError("fused_gat: N and D must be nonzero")
    if wh.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"fused_gat: no kernel for {wh.device}")


@torch.library.custom_op("gnn_rul_tpu_torch::fused_gat", mutates_args=(),
                         device_types="cpu")
def _op(wh: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
        adj: torch.Tensor, bias: torch.Tensor, slope: float) -> torch.Tensor:
    _check(wh, f1, f2, adj, bias)
    return fused_gat_plain(wh, f1, f2, adj, bias, slope)


@_op.register_kernel("cuda")
def _op_cuda(wh: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
             adj: torch.Tensor, bias: torch.Tensor,
             slope: float) -> torch.Tensor:
    _check(wh, f1, f2, adj, bias)
    return fused_gat.forward(wh, f1, f2, adj, bias, slope)


@_op.register_fake
def _op_fake(wh: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
             adj: torch.Tensor, bias: torch.Tensor,
             slope: float) -> torch.Tensor:
    _check(wh, f1, f2, adj, bias)
    return torch.empty_like(wh)


@_op.register_vmap
def _op_vmap(info, in_dims, wh, f1, f2, adj, bias, slope):
    s = info.batch_size
    folded = (fold(t, dim, s) for t, dim in zip((wh, f1, f2), in_dims))
    out = _op(*folded, groups(adj, in_dims[3], s, 2),
              groups(bias, in_dims[4], s, 0), slope)
    return unfold(out, s), 0


def _setup_context(ctx, inputs, output) -> None:
    *tensors, ctx.slope = inputs
    ctx.save_for_backward(*tensors)


def _backward(ctx, g):
    needs = ctx.needs_input_grad[:5]
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        out = fused_gat_plain(*inputs, ctx.slope)
        grads = iter(torch.autograd.grad(
            out, [t for t, need in zip(inputs, needs) if need], g))
    return (*(next(grads) if need else None for need in needs), None)


_op.register_autograd(_backward, setup_context=_setup_context)


class FusedGat:
    """The wrapper. ``launches`` counts launches of the kernel at either
    dtype and ``bf16_launches`` the bf16 instantiation's share; nothing
    else adds to them."""

    def __init__(self) -> None:
        self.launches = 0
        self.bf16_launches = 0
        self._lib: Optional[ctypes.CDLL] = None

    def load(self) -> str:
        """Build (if needed) and load the library; returns nvcc's log of the
        sources built by this call."""
        if self._lib is not None:
            return ""
        built = build_libraries()
        lib = ctypes.CDLL(str(built["fused_gat"][0]))
        for fn in (lib.fused_gat_fwd, lib.fused_gat_fwd_bf16):
            fn.argtypes = ([ctypes.c_void_p] * 5
                           + [ctypes.c_float, ctypes.c_void_p]
                           + [ctypes.c_int] * 5 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.fused_gat_error_string.argtypes = [ctypes.c_int]
        lib.fused_gat_error_string.restype = ctypes.c_char_p
        lib.fused_gat_plan.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)])
        lib.fused_gat_plan.restype = ctypes.c_int
        self._lib = lib
        return "".join(log for _, log in built.values())

    def kernel_plan(self, b: int, n: int, d: int,
                    part: Optional[int] = None) -> dict:
        """The plan as the built library chooses it (the keys of
        :func:`gat_plan`)."""
        self.load()
        out = (ctypes.c_longlong * 6)()
        err = self._lib.fused_gat_plan(b, n, d, b if part is None else part,
                                       out)
        if err != 0:
            raise ValueError(f"fused_gat: no plan for B={b}, N={n}, D={d}")
        return dict(zip(("graphs", "rows", "cols", "row_tiles", "blocks",
                         "smem"), out))

    def __call__(self, wh: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                 adj: torch.Tensor, bias: torch.Tensor,
                 slope: float) -> torch.Tensor:
        named = (("wh", wh), ("f1", f1), ("f2", f2), ("adj", adj),
                 ("bias", bias))
        for name, t in named:
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"fused_gat: {name} must be a tensor, got "
                                f"{type(t).__name__}")
        return _op(wh, f1, f2, adj, bias, float(slope))

    def forward(self, wh: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                adj: torch.Tensor, bias: torch.Tensor,
                slope: float) -> torch.Tensor:
        """The kernel alone, on CUDA tensors that :func:`_check` accepts:
        one launch for all the groups, without autograd."""
        if wh.device.type != "cuda":
            raise ValueError(f"fused_gat: the kernel runs on CUDA tensors, "
                             f"got {wh.device}")
        b, n, d = wh.shape
        if n > MAX_N:
            raise ValueError(f"fused_gat: N={n}; the kernel takes N <= {MAX_N}")
        self.load()
        out = torch.empty_like(wh)
        if b == 0:
            return out
        bf16 = wh.dtype == torch.bfloat16
        entry = self._lib.fused_gat_fwd_bf16 if bf16 else \
            self._lib.fused_gat_fwd
        with torch.cuda.device(wh.device):
            stream = torch.cuda.current_stream(wh.device).cuda_stream
            err = entry(
                wh.data_ptr(), f1.data_ptr(), f2.data_ptr(), adj.data_ptr(),
                bias.data_ptr(), slope, out.data_ptr(), b, n, d,
                adj_groups(adj), bias.numel(), stream)
        if err != 0:
            msg = self._lib.fused_gat_error_string(err).decode()
            raise RuntimeError(f"fused_gat launch failed (B={b}, N={n}, "
                               f"D={d}): {msg}")
        self.launches += 1
        self.bf16_launches += bf16
        return out


fused_gat = FusedGat()
