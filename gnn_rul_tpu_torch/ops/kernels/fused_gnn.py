"""Fused dot-graph chain: hand-written CUDA kernels and their plain versions.

    out = ((softmax(leaky_relu(h h^T - 1e8 I, 0.01)) + I) * mask) @ x

h ``(B, N, D)``, x ``(B, N, F)``, mask ``(N, N)`` -> ``(B, N, F)``, all fp32
or all bf16 (``--precision bf16``): a bf16 call reads bf16, computes in
fp32 and rounds the output once to bf16, as the Pallas kernel does with
``preferred_element_type=jnp.float32``; its backward writes dh, dx and the
mask's gradient in bf16 from fp32 sums. The
mask may also be ``(G, N, N)`` with B a multiple of G: the batch is then G
equal groups of graphs, group g masked by ``mask[g]`` (seed-parallel runs,
``train/vectorized.py``: a seed's graphs are one group). G = 1, or a
``(N, N)`` mask, is the one call of before, on the same plans.

Counterpart of ``gnn_rul_tpu/ops/pallas/fused_gnn.py``, forward and
backward. :data:`fused_dot_graph_spmm` is the wrapper the model calls. It
calls the registered operator ``gnn_rul_tpu_torch::fused_dot_graph_spmm``,
whose implementation PyTorch's dispatcher picks by the device of the
tensors when the call runs: on the CPU :func:`fused_dot_graph_spmm_plain`,
on CUDA the plan of ``gnn_rul_tpu_torch/csrc/fused_gnn.cu`` for
(B, N, D, F) (whole graphs a block wherever a graph fits a block's shared
memory, else the row-tile stream; one launch either way); on any other
device it raises. A shape-only fake implementation lets ``torch.export``
trace the operator into a program at a symbolic batch, so an exported
program calls the kernel, not the plain version. The operator's autograd
formula saves h, x and mask and recomputes the chain in the backward, as
the TPU kernel does, so nothing ``(N, N)`` is kept between the passes:
on CUDA the plan of ``csrc/fused_gnn_bwd.cu`` for (N, D, F) (one launch
where a graph fits a block's shared memory, else two), on the CPU
:func:`fused_dot_graph_spmm_bwd_plain`. Each C entry chooses its plan and
reports the launches it made; :func:`fwd_plan` and :func:`bwd_plan`
mirror the choices. Under ``torch.func.vmap`` the operator's rule folds the
seeds into B and a mapped mask into G, so all seeds run in one launch of
each kernel (``batching.py``).

The kernels are compiled with ``nvcc`` for ``sm_90a`` at their first
launch (``ops/kernels/build.py``), never at import, and called through
``ctypes`` on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..edge_count import record_edges
from .batching import fold, groups, unfold
from .build import build_libraries

MAX_FEAT = 128  # kMaxFeat in the sources: the limit on D and on F
DTYPES = (torch.float32, torch.bfloat16)  # the kernels' instantiations
_ROWS_PER_BLOCK = 8  # kRowsPerBlock in the sources
SMEM_LIMIT = 232448  # shared memory a block may use on an H100
_TARGET_BLOCKS = 132  # kTargetBlocks in fused_gnn.cu: an H100's SMs
_WORK_PER_BLOCK = 2048  # kWorkPerBlock: pairs or outputs a block
_TILE_ROWS = 32  # kTileRows: rows a block's 8 warps take, 4 each, a round
_MAX_GRID_Y = 65535  # row tiles a graph of the row-tile plans


def _quad_stride(width: int) -> int:
    # quad_stride in the source: a staged row's stride for 16-byte reads
    return 4 * ((width + 3) // 4 | 1)


def _graph_floats(n: int, d: int, f: int, g: int, r: int) -> int:
    # graph_floats in fused_gnn.cu: g graphs' h at quad_stride(D), their
    # (r, quad_stride(N)) tiles of A and x at round4(N) rows, r mask rows
    return g * (n * _quad_stride(d) + r * _quad_stride(n)
                + (n + 3) // 4 * 4 * f) + r * n


def fwd_plan(b: int, n: int, d: int, f: int, groups: int = 1) -> dict:
    """The forward's plan for (B, N, D, F) as ``csrc/fused_gnn.cu`` chooses
    it, computed here without the library: ``{"whole", "graphs", "rows",
    "row_tiles", "blocks", "smem"}``. ``whole``: a block holds
    ``graphs`` whole graphs (from B = 132 on, as many as bring its pairs or
    outputs to about 2,048 while keeping B / 132 blocks), or below B = 132
    ``rows`` rows of one staged graph over ``row_tiles`` blocks a graph;
    wherever one graph's h, x, A tile and the mask fit a block's shared
    memory. Else the row-tile stream: 8 rows of a graph a block. One launch
    either way; ``smem`` is a block's shared memory in bytes. With
    ``groups`` G > 1 a block of whole graphs holds graphs of one group
    only: the most graphs, up to the ungrouped plan's, that divide B / G."""
    if min(b, n, d, f, groups) <= 0 or max(d, f) > MAX_FEAT \
            or b % groups:
        raise ValueError(f"fused_dot_graph_spmm: no plan for B={b}, N={n}, "
                         f"D={d}, F={f}")
    one = _graph_floats(n, d, f, 1, n)
    if 4 * one > SMEM_LIMIT:
        tiles = -(-n // _ROWS_PER_BLOCK)
        if tiles > _MAX_GRID_Y:
            raise ValueError(f"fused_dot_graph_spmm: N={n} exceeds the grid "
                             f"limit of the row-tile plans")
        return {"whole": False, "graphs": 1, "rows": _ROWS_PER_BLOCK,
                "row_tiles": tiles, "blocks": b * tiles,
                "smem": 4 * (_ROWS_PER_BLOCK * d + 32 * (d | 1) + 32 * f)}
    if b >= _TARGET_BLOCKS:
        g = max(1, min(_WORK_PER_BLOCK // (n * max(n, f)),
                       (SMEM_LIMIT // 4 - n * n) // (one - n * n),
                       b // _TARGET_BLOCKS))
        while groups > 1 and (b // groups) % g:
            g -= 1
        return {"whole": True, "graphs": g, "rows": n, "row_tiles": 1,
                "blocks": -(-b // g),
                "smem": 4 * _graph_floats(n, d, f, g, n)}
    tiles = min(-(-_TARGET_BLOCKS // b), -(-n // _TILE_ROWS))
    rows = min(n, (-(-n // tiles) + 3) // 4 * 4)
    row_tiles = -(-n // rows)
    return {"whole": True, "graphs": 1, "rows": rows, "row_tiles": row_tiles,
            "blocks": b * row_tiles,
            "smem": 4 * _graph_floats(n, d, f, 1, rows)}


def bwd_plan(n: int, d: int, f: int) -> dict:
    """The backward's plan for (N, D, F) as ``csrc/fused_gnn_bwd.cu``
    chooses it, computed here without the library: ``{"launches",
    "smem"}``. One launch (a block per graph) wherever the graph's h, x, g,
    the mask and two (N, N) tiles fit a block's shared memory; else the row
    pass and the column pass, two launches."""
    graph = 4 * (n * _quad_stride(d) + 2 * n * _quad_stride(f) + n * n
                 + 2 * n * (n | 1))
    if graph <= SMEM_LIMIT:
        return {"launches": 1, "smem": graph}
    return {"launches": 2, "smem": 4 * (_ROWS_PER_BLOCK * (d + f)
                                        + 32 * ((d | 1) + (f | 1) + 3))}


def bwd_launches_per_call(n: int, d: int, f: int) -> int:
    """Kernel launches of one backward call at (N, D, F)."""
    return bwd_plan(n, d, f)["launches"]


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A bf16 operand in fp32, the kernels' working precision; any other
    dtype as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _grouped(*tensors: torch.Tensor, mask: torch.Tensor):
    """A grouped call's tensors as ``(G, B / G, ...)`` and its mask as
    ``(G, 1, N, N)``, to broadcast per group."""
    g = mask.shape[0]
    return (*(t.unflatten(0, (g, -1)) for t in tensors), mask[:, None])


def fused_dot_graph_spmm_plain(h: torch.Tensor, x: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the chain, in the order of the JAX
    ``fused_dot_graph_spmm_reference``; a grouped mask broadcasts over its
    group's graphs. bf16 operands are computed on in fp32 and the output
    rounded once to bf16."""
    dtype = x.dtype
    h, x, mask = _wide(h), _wide(x), _wide(mask)
    if mask.dim() == 3:
        return fused_dot_graph_spmm_plain(*_grouped(h, x, mask=mask)
                                          ).flatten(0, 1).to(dtype)
    n = h.shape[-2]
    eye = torch.eye(n, dtype=h.dtype, device=h.device)
    s = torch.einsum("...nd,...md->...nm", h, h)
    s = F.leaky_relu(s - eye * 1e8, 0.01)
    a = torch.softmax(s, dim=-1) + eye
    a = a * mask
    return torch.einsum("...nm,...md->...nd", a, x).to(dtype)


def fused_dot_graph_spmm_bwd_plain(
        h: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
        g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, step by step as the JAX
    ``_bwd_kernel`` writes it. Returns ``(dh, dx, dmask_per_sample)``; the
    last is ``(B, N, N)``, to be summed over the batch (over each group's
    graphs for a grouped mask) for the mask's gradient. bf16 operands are
    computed on in fp32 and each result rounded once to its operand's
    dtype."""
    dtypes = h.dtype, x.dtype, mask.dtype
    h, x, mask, g = _wide(h), _wide(x), _wide(mask), _wide(g)
    if mask.dim() == 3:
        h, x, g, mask = _grouped(h, x, g, mask=mask)
        return tuple(t.flatten(0, 1).to(dt) for t, dt in zip(
            fused_dot_graph_spmm_bwd_plain(h, x, mask, g), dtypes))
    n = h.shape[-2]
    eye = torch.eye(n, dtype=h.dtype, device=h.device)
    s = torch.einsum("...nd,...md->...nm", h, h) - eye * 1e8
    p = torch.softmax(F.leaky_relu(s, 0.01), dim=-1)
    a = (p + eye) * mask
    dx = torch.einsum("...nm,...nf->...mf", a, g)
    da = torch.einsum("...nf,...mf->...nm", g, x)
    dmask = (p + eye) * da
    dp = da * mask
    inner = (dp * p).sum(dim=-1, keepdim=True)
    dz = p * (dp - inner)
    ds = dz * torch.where(s >= 0, 1.0, 0.01).to(s.dtype)
    dh = (torch.einsum("...nm,...md->...nd", ds, h)
          + torch.einsum("...nm,...nd->...md", ds, h))
    return dh.to(dtypes[0]), dx.to(dtypes[1]), dmask.to(dtypes[2])


def _check(h: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
           g: Optional[torch.Tensor] = None) -> None:
    named = [("h", h), ("x", x), ("mask", mask)]
    if g is not None:
        named.append(("g", g))
    if h.dtype not in DTYPES:
        raise TypeError(f"fused_dot_graph_spmm: h must be float32 or "
                        f"bfloat16, got {h.dtype}")
    for name, t in named:
        if t.dtype != h.dtype:
            raise TypeError(f"fused_dot_graph_spmm: {name} is {t.dtype}, h "
                            f"{h.dtype}; every operand takes one dtype")
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
    if g is not None and g.shape != x.shape:
        raise ValueError(f"fused_dot_graph_spmm: g {tuple(g.shape)} does not "
                         f"match x {tuple(x.shape)}")
    if not ((mask.dim() == 2 and mask.shape == (n, n))
            or (mask.dim() == 3 and mask.shape[1:] == (n, n)
                and mask.shape[0] > 0 and b % mask.shape[0] == 0)):
        raise ValueError(f"fused_dot_graph_spmm: mask must be (N, N) = ({n}, "
                         f"{n}) or (G, N, N) with G dividing B={b}, got "
                         f"{tuple(mask.shape)}")
    if min(n, d, x.shape[2]) == 0:
        raise ValueError("fused_dot_graph_spmm: N, D and F must be nonzero")
    if d > MAX_FEAT or x.shape[2] > MAX_FEAT:
        raise ValueError(f"fused_dot_graph_spmm: D={d}, F={x.shape[2]}; the "
                         f"kernel takes D, F <= {MAX_FEAT}")
    # A whole graph fits a block only up to N = 168 (fwd_plan, bwd_plan), so
    # at such N both directions launch their row-tile plans, whose grid is
    # (B, ceil(N / 8)) blocks.
    if -(-n // _ROWS_PER_BLOCK) > _MAX_GRID_Y:
        raise ValueError(f"fused_dot_graph_spmm: N={n} exceeds the grid "
                         f"limit of the row-tile plans")
    if h.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"fused_dot_graph_spmm: no kernel for {h.device}")


def _groups(mask: torch.Tensor) -> int:
    return 1 if mask.dim() == 2 else mask.shape[0]


@torch.library.custom_op("gnn_rul_tpu_torch::fused_dot_graph_spmm",
                         mutates_args=(), device_types="cpu")
def _op(h: torch.Tensor, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    _check(h, x, mask)
    return fused_dot_graph_spmm_plain(h, x, mask)


@_op.register_kernel("cuda")
def _op_cuda(h: torch.Tensor, x: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    _check(h, x, mask)
    return fused_dot_graph_spmm.forward(h, x, mask)


@_op.register_fake
def _op_fake(h: torch.Tensor, x: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    _check(h, x, mask)
    return h.new_empty((h.shape[0], h.shape[1], x.shape[2]))


@_op.register_vmap
def _op_vmap(info, in_dims, h, x, mask):
    s = info.batch_size
    out = _op(fold(h, in_dims[0], s), fold(x, in_dims[1], s),
              groups(mask, in_dims[2], s, 2))
    return unfold(out, s), 0


def _setup_context(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs)


def _backward(ctx, g):
    h, x, mask = ctx.saved_tensors
    need_h, need_x, need_mask = ctx.needs_input_grad
    # Autograd does not promise a contiguous cotangent.
    dh, dx, dmask = fused_dot_graph_spmm.backward(h, x, mask, g.contiguous(),
                                                  need_dmask=need_mask)
    if need_mask:
        dmask = (dmask.sum(dim=0) if mask.dim() == 2 else
                 dmask.unflatten(0, (mask.shape[0], -1)).sum(dim=1))
    return (dh if need_h else None, dx if need_x else None,
            dmask if need_mask else None)


_op.register_autograd(_backward, setup_context=_setup_context)


class FusedDotGraphSpmm:
    """The wrapper. ``launches`` counts launches of the forward's kernels and
    ``bwd_launches`` those of the backward's, as each C entry reports them,
    at either dtype; ``bf16_launches`` and ``bf16_bwd_launches`` count the
    bf16 instantiations' share of them; nothing else adds to them.
    ``bwd_calls`` counts the backward's calls that launched."""

    def __init__(self) -> None:
        self.launches = 0
        self.bwd_launches = 0
        self.bf16_launches = 0
        self.bf16_bwd_launches = 0
        self.bwd_calls = 0
        self._plans: dict = {}
        self._fwd: Optional[ctypes.CDLL] = None
        self._bwd: Optional[ctypes.CDLL] = None

    def load(self) -> str:
        """Build (if needed) and load the libraries; returns nvcc's log of
        the sources built by this call."""
        if self._fwd is not None:
            return ""
        built = build_libraries()
        fwd = ctypes.CDLL(str(built["fused_gnn"][0]))
        for fn in (fwd.fused_dot_graph_spmm_fwd,
                   fwd.fused_dot_graph_spmm_fwd_bf16):
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
            fn.restype = ctypes.c_int
        fwd.fused_dot_graph_spmm_fwd_plan.argtypes = (
            [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)])
        fwd.fused_dot_graph_spmm_fwd_plan.restype = ctypes.c_int
        fwd.fused_dot_graph_spmm_error_string.argtypes = [ctypes.c_int]
        fwd.fused_dot_graph_spmm_error_string.restype = ctypes.c_char_p
        bwd = ctypes.CDLL(str(built["fused_gnn_bwd"][0]))
        bwd.fused_dot_graph_spmm_bwd.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
            + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        bwd.fused_dot_graph_spmm_bwd.restype = ctypes.c_int
        # The bf16 entry takes one pointer more: the two-launch plan's fp32
        # (B, N, D) scratch for dh's row term.
        bwd.fused_dot_graph_spmm_bwd_bf16.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
            + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        bwd.fused_dot_graph_spmm_bwd_bf16.restype = ctypes.c_int
        bwd.fused_dot_graph_spmm_bwd_plan.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)])
        bwd.fused_dot_graph_spmm_bwd_plan.restype = ctypes.c_int
        bwd.fused_dot_graph_spmm_bwd_error_string.argtypes = [ctypes.c_int]
        bwd.fused_dot_graph_spmm_bwd_error_string.restype = ctypes.c_char_p
        for lib, fn in ((fwd, "fused_dot_graph_spmm_max_feat"),
                        (bwd, "fused_dot_graph_spmm_bwd_max_feat")):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
            if getattr(lib, fn)() != MAX_FEAT:
                raise RuntimeError(f"{fn}: kernel limit differs from MAX_FEAT")
        self._fwd, self._bwd = fwd, bwd
        return "".join(log for _, log in built.values())

    def __call__(self, h: torch.Tensor, x: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        record_edges(h.shape[:-1] + (h.shape[-2],))
        return _op(h, x, mask)

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """The kernel alone, on CUDA tensors that :func:`_check` accepts:
        one launch for all the groups, without autograd."""
        if h.device.type != "cuda":
            raise ValueError(f"fused_dot_graph_spmm: the kernel runs on CUDA "
                             f"tensors, got {h.device}")
        self.load()
        b, n, d = h.shape
        f = x.shape[2]
        out = torch.empty((b, n, f), dtype=x.dtype, device=x.device)
        if b == 0:
            return out
        launched = ctypes.c_int()
        bf16 = h.dtype == torch.bfloat16
        entry = (self._fwd.fused_dot_graph_spmm_fwd_bf16 if bf16
                 else self._fwd.fused_dot_graph_spmm_fwd)
        with torch.cuda.device(h.device):
            stream = torch.cuda.current_stream(h.device).cuda_stream
            err = entry(
                h.data_ptr(), x.data_ptr(), mask.data_ptr(), out.data_ptr(),
                b, n, d, f, _groups(mask), stream, ctypes.byref(launched))
        self.launches += launched.value
        if bf16:
            self.bf16_launches += launched.value
        if err != 0:
            msg = self._fwd.fused_dot_graph_spmm_error_string(err).decode()
            raise RuntimeError(f"fused_dot_graph_spmm launch failed "
                               f"(B={b}, N={n}, D={d}, F={f}): {msg}")
        return out

    def kernel_fwd_plan(self, b: int, n: int, d: int, f: int,
                        groups: int = 1) -> dict:
        """The forward's plan as the built library chooses it (the keys of
        :func:`fwd_plan`)."""
        self.load()
        out = (ctypes.c_longlong * 6)()
        err = self._fwd.fused_dot_graph_spmm_fwd_plan(b, n, d, f, groups, out)
        if err != 0:
            raise ValueError(f"fused_dot_graph_spmm: no plan for B={b}, "
                             f"N={n}, D={d}, F={f}")
        plan = dict(zip(("whole", "graphs", "rows", "row_tiles", "blocks",
                         "smem"), out))
        plan["whole"] = bool(plan["whole"])
        return plan

    def kernel_plan(self, n: int, d: int, f: int) -> dict:
        """The backward's plan as the built library chooses it (the same
        keys as :func:`bwd_plan`)."""
        if (n, d, f) not in self._plans:
            self.load()
            smem = ctypes.c_longlong()
            launches = self._bwd.fused_dot_graph_spmm_bwd_plan(
                n, d, f, ctypes.byref(smem))
            self._plans[n, d, f] = {"launches": launches, "smem": smem.value}
        return dict(self._plans[n, d, f])

    def backward(self, h: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                 g: torch.Tensor, need_dmask: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """``(dh, dx, dmask_per_sample)`` for the cotangent ``g``: the
        kernels on CUDA (one launch for all the groups where a graph fits a
        block), plain on the CPU. ``dmask_per_sample`` is ``(B, N, N)`` when
        ``need_dmask``, else None."""
        _check(h, x, mask, g)
        if h.device.type == "cpu":
            dh, dx, dmask = fused_dot_graph_spmm_bwd_plain(h, x, mask, g)
            return dh, dx, dmask if need_dmask else None
        self.load()
        b, n, d = h.shape
        f = x.shape[2]
        dh = torch.empty_like(h)
        dx = torch.empty_like(x)
        dmask = (torch.empty((b, n, n), dtype=mask.dtype, device=h.device)
                 if need_dmask else None)
        if b == 0:
            return dh, dx, dmask
        two = self.kernel_plan(n, d, f)["launches"] == 2
        stats = (torch.empty((b, n, 3), dtype=torch.float32, device=h.device)
                 if two else None)
        bf16 = h.dtype == torch.bfloat16
        launched = ctypes.c_int()
        args = [h.data_ptr(), x.data_ptr(), mask.data_ptr(), g.data_ptr(),
                dh.data_ptr(), dx.data_ptr(),
                dmask.data_ptr() if need_dmask else None,
                stats.data_ptr() if stats is not None else None]
        if bf16:
            part = (torch.empty((b, n, d), dtype=torch.float32,
                                device=h.device) if two else None)
            args.append(part.data_ptr() if part is not None else None)
        entry = (self._bwd.fused_dot_graph_spmm_bwd_bf16 if bf16
                 else self._bwd.fused_dot_graph_spmm_bwd)
        with torch.cuda.device(h.device):
            stream = torch.cuda.current_stream(h.device).cuda_stream
            err = entry(*args, b, n, d, f, _groups(mask), stream,
                        ctypes.byref(launched))
        self.bwd_launches += launched.value
        if bf16:
            self.bf16_bwd_launches += launched.value
        if err != 0:
            msg = self._bwd.fused_dot_graph_spmm_bwd_error_string(err).decode()
            raise RuntimeError(f"fused_dot_graph_spmm backward launch failed "
                               f"(B={b}, N={n}, D={d}, F={f}): {msg}")
        self.bwd_calls += 1
        return dh, dx, dmask


fused_dot_graph_spmm = FusedDotGraphSpmm()
