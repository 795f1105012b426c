"""Whole bidirectional LSTM recurrence: hand-written CUDA kernels and their
plain versions.

    lstm_recurrence(xg (T, 2, B, 4H), w_hh (2, H, 4H))
        -> ys (T, 2, B, H), c_fin (2, B, H)

xg holds the projected gate inputs ``x @ w_ih + b_ih + b_hh`` of both
directions, direction 1 already flipped in time; w_hh is in the JAX layout
(rows h, columns the gates [i, f, g, o]); h and c start at zero; all fp32,
or all bf16 (``--precision bf16``), where the Pallas kernel's semantics
hold: h and c carried in fp32, ys and cs stored in bf16 each step (c_fin
is the last cs), the backward recomputing the gates from the stored bf16
ys and cs, its carry and dgates in fp32, dxg written in bf16 and dw_hh
summed in fp64 and rounded once to bf16.
w_hh may also be ``(G, 2, H, 4H)`` with B a multiple of G: the batch
columns are then G equal groups, group g run with ``w_hh[g]``
(seed-parallel runs, ``train/vectorized.py``: a seed's columns are one
group), and dw_hh is per group too. G = 1, or a ``(2, H, 4H)`` w_hh, is the
one call of before, on the same plans. Under ``torch.func.vmap`` the
operator's rule folds the seeds into B (``(S, T, 2, B, 4H) -> (T, 2, S*B,
4H)``, one copy) and a mapped w_hh into G, so all seeds run in one launch
of each kernel (``batching.py``).

Counterpart of ``gnn_rul_tpu/ops/pallas/fused_lstm.py``, forward and
backward. :data:`lstm_recurrence` is the wrapper ``nn/recurrent.py`` calls.
It calls the registered operator ``gnn_rul_tpu_torch::lstm_recurrence
(xg, w_hh) -> (ys, cs, c_fin)``, whose implementation PyTorch's dispatcher
picks by the device of the tensors when the call runs: on the CPU the time
loop :func:`lstm_trajectory_plain`, on CUDA the kernel in
``gnn_rul_tpu_torch/csrc/fused_lstm.cu``; on any other device it raises. A
shape-only fake implementation lets ``torch.export`` trace the operator
with T symbolic (LOGO's T is the request's batch, HAGCN's 14 times it),
where the plain time loop would pin T. The operator's autograd formula saves xg, w_hh, ys and
the whole c trajectory cs, as the JAX ``_fwd`` does, and returns dxg and
dw_hh; cs is an output for the backward's sake and carries no gradient,
and the cotangent of an output the caller never used (LOGO never reads
c_fin) is zeros. On CUDA the backward launches the four kernels in
``csrc/fused_lstm_bwd.cu`` (the gate pass, which recomputes the activated
gates of every step in parallel, the reverse sweep, the dW_hh partial
sums, their fixed-order reduction), on the CPU it runs
:func:`lstm_recurrence_bwd_plain`, which is :func:`lstm_gates_plain`
followed by :func:`lstm_sweep_plain`.

The kernels are compiled with ``nvcc`` for ``sm_90a`` at their first
launch (``ops/kernels/build.py``), never at import, and called through
``ctypes`` on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...telemetry import span
from .batching import fold, groups, unfold
from .build import build_libraries

MAX_HIDDEN = 1024  # kMaxHidden in the sources
DTYPES = (torch.float32, torch.bfloat16)  # the kernels' instantiations
# the gate pass, the reverse sweep, dW partials, dW reduction
BWD_LAUNCHES_PER_CALL = 4
PLAN_FIELDS = ("lanes", "cluster", "units", "threads", "iters", "w_mode",
               "smem")
W_MODES = ("global memory", "shared memory", "registers")  # w_mode 0, 1, 2


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A bf16 operand in fp32, the kernels' working precision; any other
    dtype as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _gates(gates: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def _times_w(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``v (..., 2, B, H) @ w (2, H, K)``, or for a grouped ``w (G, 2, H,
    K)`` each group's columns of v by its own w."""
    if w.dim() == 3:
        return torch.matmul(v, w)
    v = v.unflatten(-2, (w.shape[0], -1)).transpose(-4, -3)
    return torch.matmul(v, w).transpose(-4, -3).flatten(-3, -2)


def lstm_trajectory_plain(xg: torch.Tensor, w_hh: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ys, cs)``, both ``(T, 2, B, H)``: the time loop of the JAX
    ``lstm_recurrence_reference``, keeping every step's c. At bf16 the
    carry stays fp32 and each step's h and c are stored rounded."""
    dtype = xg.dtype
    xg, w_hh = _wide(xg), _wide(w_hh)
    _, _, b, _ = xg.shape
    h = xg.new_zeros((2, b, w_hh.shape[-2]))
    c = torch.zeros_like(h)
    ys, cs = [], []
    for xt in xg:
        i, f, g, o = _gates(xt + _times_w(h, w_hh))
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h.to(dtype))
        cs.append(c.to(dtype))
    return torch.stack(ys), torch.stack(cs)


def lstm_recurrence_plain(xg: torch.Tensor, w_hh: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward: ``(ys, c_fin)``."""
    ys, cs = lstm_trajectory_plain(xg, w_hh)
    return ys, cs[-1]


def _h_prev(ys: torch.Tensor) -> torch.Tensor:
    """``ys`` one step later: step t's h_prev, zero at t = 0."""
    return torch.cat([torch.zeros_like(ys[:1]), ys[:-1]])


def lstm_gates_plain(xg: torch.Tensor, w_hh: torch.Tensor, ys: torch.Tensor
                     ) -> torch.Tensor:
    """Plain PyTorch version of the backward's gate pass: the activated
    gates ``act(xg[t] + ys[t-1] @ w_hh)`` of every step, (T, 2, B, 4H), with
    zero in place of ``ys[-1]``; they depend on the saved trajectory alone,
    not on the backward's carry. fp32 at bf16 operands, as the kernel
    keeps them."""
    xg, w_hh, ys = _wide(xg), _wide(w_hh), _wide(ys)
    i, f, g, o = _gates(xg + _times_w(_h_prev(ys), w_hh))
    return torch.cat([i, f, g, o], dim=-1)


def lstm_sweep_plain(
        gates: torch.Tensor, w_hh: torch.Tensor, ys: torch.Tensor,
        cs: torch.Tensor, dys: torch.Tensor, dc_fin: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward's reverse sweep and dW pass, on
    the activated gates of :func:`lstm_gates_plain`: the carry's recurrence
    as the JAX ``_bwd_kernel`` writes it, dc seeded from ``dc_fin``, then
    dW_hh as one product over the T*B rows (of each group's columns for a
    grouped w_hh). Returns ``(dxg, dw_hh)``; at bf16 both are rounded
    once from the fp32 dgates and sums."""
    dtype = ys.dtype
    w_hh, ys, cs, dys, dc_fin = (_wide(t) for t in (w_hh, ys, cs, dys,
                                                    dc_fin))
    zeros = torch.zeros_like(ys[0])
    dh, dc = zeros, dc_fin
    dxg = torch.empty_like(gates)
    for t in reversed(range(gates.shape[0])):
        i, f, g, o = gates[t].chunk(4, dim=-1)
        c_prev = cs[t - 1] if t else zeros
        dh = dh + dys[t]
        tc = torch.tanh(cs[t])
        dc = dh * o * (1.0 - tc * tc) + dc
        dgates = torch.cat([dc * g * i * (1.0 - i),
                            dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - g * g),
                            dh * tc * o * (1.0 - o)], dim=-1)
        dxg[t] = dgates
        dh = _times_w(dgates, w_hh.transpose(-1, -2))
        dc = dc * f
    # At bf16 dW sums in fp64, as the kernel's partials do, and is rounded
    # through fp32 to bf16 as the kernel rounds it.
    rows = [_h_prev(ys), dxg]
    if dtype == torch.bfloat16:
        rows = [t.double() for t in rows]
    if w_hh.dim() == 3:
        dw = torch.einsum("tdbh,tdbg->dhg", *rows)
    else:
        by_group = [t.unflatten(2, (w_hh.shape[0], -1)) for t in rows]
        dw = torch.einsum("tdpbh,tdpbg->pdhg", *by_group)
    return dxg.to(dtype), dw.float().to(dtype)


def lstm_recurrence_bwd_plain(
        xg: torch.Tensor, w_hh: torch.Tensor, ys: torch.Tensor,
        cs: torch.Tensor, dys: torch.Tensor, dc_fin: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, in the kernels' two phases:
    the gate pass recomputes the gates from the saved h, then the reverse
    sweep; returns ``(dxg, dw_hh)`` in the forward's layouts."""
    return lstm_sweep_plain(lstm_gates_plain(xg, w_hh, ys), w_hh, ys, cs,
                            dys, dc_fin)


def _check(xg: torch.Tensor, w_hh: torch.Tensor, **extra: torch.Tensor
           ) -> None:
    named = [("xg", xg), ("w_hh", w_hh), *extra.items()]
    if xg.dtype not in DTYPES:
        raise TypeError(f"lstm_recurrence: xg must be float32 or bfloat16, "
                        f"got {xg.dtype}")
    for name, t in named:
        if t.dtype != xg.dtype:
            raise TypeError(f"lstm_recurrence: {name} is {t.dtype}, xg "
                            f"{xg.dtype}; every operand takes one dtype")
        if not t.is_contiguous():
            raise ValueError(f"lstm_recurrence: {name} must be contiguous")
        if t.device != xg.device:
            raise ValueError(f"lstm_recurrence: {name} is on {t.device}, xg "
                             f"on {xg.device}")
    if xg.dim() != 4 or xg.shape[1] != 2 or w_hh.dim() not in (3, 4):
        raise ValueError(f"lstm_recurrence: xg and w_hh must be (T, 2, B, 4H) "
                         f"and (2, H, 4H) or (G, 2, H, 4H), got "
                         f"{tuple(xg.shape)} and {tuple(w_hh.shape)}")
    t, _, b, g = xg.shape
    hid = w_hh.shape[-2]
    if w_hh.shape[-3:] != (2, hid, 4 * hid) or g != 4 * hid:
        raise ValueError(f"lstm_recurrence: w_hh {tuple(w_hh.shape)} does not "
                         f"match xg {tuple(xg.shape)}")
    if w_hh.dim() == 4 and (w_hh.shape[0] == 0 or b % w_hh.shape[0]):
        raise ValueError(f"lstm_recurrence: {w_hh.shape[0]} groups of w_hh "
                         f"do not divide B={b}")
    # Each size on its own: min() would compare a symbolic T (an exported
    # LOGO's batch, HAGCN's 14 times it) with B and H, and pin it.
    if t == 0 or b == 0 or hid == 0:
        raise ValueError("lstm_recurrence: T, B and H must be nonzero")
    if hid > MAX_HIDDEN:
        raise ValueError(f"lstm_recurrence: H={hid}; the kernels take "
                         f"H <= {MAX_HIDDEN}")
    want = {"ys": (t, 2, b, hid), "cs": (t, 2, b, hid),
            "dys": (t, 2, b, hid), "dc_fin": (2, b, hid)}
    for name, tensor in extra.items():
        if tuple(tensor.shape) != want[name]:
            raise ValueError(f"lstm_recurrence: {name} must be {want[name]}, "
                             f"got {tuple(tensor.shape)}")
    if xg.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"lstm_recurrence: no kernel for {xg.device}")


def _groups(w_hh: torch.Tensor) -> int:
    return 1 if w_hh.dim() == 3 else w_hh.shape[0]


@torch.library.custom_op("gnn_rul_tpu_torch::lstm_recurrence",
                         mutates_args=(), device_types="cpu")
def _op(xg: torch.Tensor, w_hh: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check(xg, w_hh)
    ys, cs = lstm_trajectory_plain(xg, w_hh)
    return ys, cs, cs[-1].clone()


@_op.register_kernel("cuda")
def _op_cuda(xg: torch.Tensor, w_hh: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check(xg, w_hh)
    return lstm_recurrence.forward(xg, w_hh)


@_op.register_fake
def _op_fake(xg: torch.Tensor, w_hh: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check(xg, w_hh)
    t, _, b, _ = xg.shape
    ys = xg.new_empty((t, 2, b, w_hh.shape[-2]))
    return ys, torch.empty_like(ys), xg.new_empty((2, b, w_hh.shape[-2]))


@_op.register_vmap
def _op_vmap(info, in_dims, xg, w_hh):
    s = info.batch_size
    ys, cs, c_fin = _op(fold(xg, in_dims[0], s, axis=2),
                        groups(w_hh, in_dims[1], s, 3))
    return (unfold(ys, s, 2), unfold(cs, s, 2), unfold(c_fin, s, 1)), (2, 2, 1)


def _setup_context(ctx, inputs, output) -> None:
    ys, cs, _ = output
    ctx.mark_non_differentiable(cs)
    ctx.save_for_backward(*inputs, ys, cs)


def _backward(ctx, dys, _dcs, dc_fin):
    # An output the caller never used (LOGO ignores c_fin) arrives as
    # zeros: autograd materialises undefined gradients by default.
    xg, w_hh, ys, cs = ctx.saved_tensors
    dxg, dw = lstm_recurrence.backward(xg, w_hh, ys, cs, dys.contiguous(),
                                       dc_fin.contiguous())
    need_xg, need_w = ctx.needs_input_grad
    return dxg if need_xg else None, dw if need_w else None


_op.register_autograd(_backward, setup_context=_setup_context)


class FusedLstmRecurrence:
    """The wrapper. ``launches`` counts launches of the forward kernel and
    ``bwd_launches`` those of the backward's four kernels, at either dtype;
    ``bf16_launches`` and ``bf16_bwd_launches`` count the bf16
    instantiations' share; nothing else adds to them. The kernels choose
    how a recurrence is cut (:meth:`plan`) from H, B and the device, the
    same at either dtype (W_hh is held in fp32 on chip)."""

    def __init__(self) -> None:
        self.launches = 0
        self.bwd_launches = 0
        self.bf16_launches = 0
        self.bf16_bwd_launches = 0
        self._fwd: Optional[ctypes.CDLL] = None
        self._bwd: Optional[ctypes.CDLL] = None

    def load(self) -> None:
        """Build (if needed) and load the libraries."""
        if self._fwd is not None:
            return
        with span("kernels.load.fused_lstm", first=True):
            self._open()

    def _open(self) -> None:
        built = build_libraries()
        fwd = ctypes.CDLL(str(built["fused_lstm"][0]))
        bwd = ctypes.CDLL(str(built["fused_lstm_bwd"][0]))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        signatures = [
            (fwd.fused_lstm_fwd, [ptr] * 5 + [i32] * 4 + [ptr]),
            (fwd.fused_lstm_fwd_bf16, [ptr] * 5 + [i32] * 4 + [ptr]),
            (bwd.fused_lstm_bwd_gates, [ptr] * 4 + [i32] * 4 + [ptr]),
            (bwd.fused_lstm_bwd_gates_bf16, [ptr] * 4 + [i32] * 4 + [ptr]),
            (bwd.fused_lstm_bwd_sweep, [ptr] * 5 + [i32] * 4 + [ptr]),
            # ... and the bf16 dxg beside the fp32 dgates
            (bwd.fused_lstm_bwd_sweep_bf16, [ptr] * 6 + [i32] * 4 + [ptr]),
            (bwd.fused_lstm_bwd_dw_partial, [ptr] * 3 + [i32] * 4 + [ptr]),
            (bwd.fused_lstm_bwd_dw_partial_bf16,
             [ptr] * 3 + [i32] * 4 + [ptr]),
            (bwd.fused_lstm_bwd_dw_reduce, [ptr] * 2 + [i32] * 4 + [ptr]),
            (bwd.fused_lstm_bwd_dw_reduce_bf16,
             [ptr] * 2 + [i32] * 4 + [ptr]),
            (bwd.fused_lstm_bwd_dw_chunks, [i32] * 3),
            (fwd.fused_lstm_fwd_plan, [i32] * 2 + [ptr]),
            (bwd.fused_lstm_bwd_plan, [i32] * 2 + [ptr]),
            (fwd.fused_lstm_max_hidden, []),
            (bwd.fused_lstm_bwd_max_hidden, []),
        ]
        for fn, argtypes in signatures:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for fn in (fwd.fused_lstm_error_string,
                   bwd.fused_lstm_bwd_error_string):
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_char_p
        for fn in (fwd.fused_lstm_max_hidden, bwd.fused_lstm_bwd_max_hidden):
            if fn() != MAX_HIDDEN:
                raise RuntimeError(f"{fn.__name__}: kernel limit differs from "
                                   "MAX_HIDDEN")
        self._fwd, self._bwd = fwd, bwd

    def plan(self, hidden: int, batch: int, backward: bool = False
             ) -> Optional[dict]:
        """How the forward (or the backward's sweep) cuts hidden size
        ``hidden`` at ``batch`` columns on the current device:
        ``PLAN_FIELDS`` -> int (lanes per unit, CTAs per cluster, units per
        CTA, threads, rows per lane, where W_hh sits as an index of
        ``W_MODES``, shared memory bytes); None where no plan fits."""
        self.load()
        out = (ctypes.c_int * len(PLAN_FIELDS))()
        fn = (self._bwd.fused_lstm_bwd_plan if backward
              else self._fwd.fused_lstm_fwd_plan)
        if fn(hidden, batch, ctypes.addressof(out)) != 0:
            return None
        return dict(zip(PLAN_FIELDS, out))

    def __call__(self, xg: torch.Tensor, w_hh: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(ys, c_fin)``, differentiable in xg and w_hh."""
        ys, _, c_fin = _op(xg, w_hh)
        return ys, c_fin

    def _raise(self, lib, err: int, what: str, xg: torch.Tensor) -> None:
        t, _, b, g = xg.shape
        msg = (lib.fused_lstm_error_string(err) if lib is self._fwd
               else lib.fused_lstm_bwd_error_string(err)).decode()
        raise RuntimeError(f"lstm_recurrence {what} launch failed (T={t}, "
                           f"B={b}, H={g // 4}): {msg}")

    def forward(self, xg: torch.Tensor, w_hh: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(ys, cs, c_fin)`` by the kernel alone, on CUDA tensors that
        :func:`_check` accepts: one launch for all the groups, without
        autograd."""
        if xg.device.type != "cuda":
            raise ValueError(f"lstm_recurrence: the kernel runs on CUDA "
                             f"tensors, got {xg.device}")
        self.load()
        t, _, b, g = xg.shape
        hid = g // 4
        ys = torch.empty((t, 2, b, hid), dtype=xg.dtype, device=xg.device)
        cs = torch.empty_like(ys)
        c_fin = torch.empty((2, b, hid), dtype=xg.dtype, device=xg.device)
        bf16 = xg.dtype == torch.bfloat16
        entry = self._fwd.fused_lstm_fwd_bf16 if bf16 else \
            self._fwd.fused_lstm_fwd
        with torch.cuda.device(xg.device):
            stream = torch.cuda.current_stream(xg.device).cuda_stream
            err = entry(
                xg.data_ptr(), w_hh.data_ptr(), ys.data_ptr(), cs.data_ptr(),
                c_fin.data_ptr(), t, b, hid, _groups(w_hh), stream)
        if err != 0:
            self._raise(self._fwd, err, "forward", xg)
        self.launches += 1
        self.bf16_launches += bf16
        return ys, cs, c_fin

    def gates(self, xg: torch.Tensor, w_hh: torch.Tensor, ys: torch.Tensor
              ) -> torch.Tensor:
        """The backward's gate pass alone: the gate kernel on CUDA,
        :func:`lstm_gates_plain` on the CPU; the gates in fp32 at either
        dtype."""
        _check(xg, w_hh, ys=ys)
        if xg.device.type == "cpu":
            return lstm_gates_plain(xg, w_hh, ys)
        self.load()
        t, _, b, g = xg.shape
        out = torch.empty(xg.shape, dtype=torch.float32, device=xg.device)
        bf16 = xg.dtype == torch.bfloat16
        entry = self._bwd.fused_lstm_bwd_gates_bf16 if bf16 else \
            self._bwd.fused_lstm_bwd_gates
        with torch.cuda.device(xg.device):
            stream = torch.cuda.current_stream(xg.device).cuda_stream
            err = entry(
                xg.data_ptr(), w_hh.data_ptr(), ys.data_ptr(), out.data_ptr(),
                t, b, g // 4, _groups(w_hh), stream)
        if err != 0:
            self._raise(self._bwd, err, "backward gate", xg)
        self.bwd_launches += 1
        self.bf16_bwd_launches += bf16
        return out

    def backward(self, xg: torch.Tensor, w_hh: torch.Tensor, ys: torch.Tensor,
                 cs: torch.Tensor, dys: torch.Tensor, dc_fin: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(dxg, dw_hh)``: the four kernels on CUDA, each one launch for
        all the groups; plain on the CPU."""
        _check(xg, w_hh, ys=ys, cs=cs, dys=dys, dc_fin=dc_fin)
        if xg.device.type == "cpu":
            return lstm_recurrence_bwd_plain(xg, w_hh, ys, cs, dys, dc_fin)
        # The gate pass writes the activated gates into an fp32 buffer (at
        # fp32, dxg's); the sweep overwrites them with the dgates, and at
        # bf16 also writes them rounded into dxg. dW sums the fp32 dgates.
        work = self.gates(xg, w_hh, ys)
        bf16 = xg.dtype == torch.bfloat16
        dxg = torch.empty_like(xg) if bf16 else work
        t, _, b, g = xg.shape
        hid = g // 4
        lib = self._bwd
        dw = torch.empty_like(w_hh)
        grp = _groups(w_hh)
        chunks = lib.fused_lstm_bwd_dw_chunks(t, b // grp, hid)
        partial = torch.empty((grp, 2, chunks, hid, g), dtype=torch.float64,
                              device=xg.device)  # the dW sums run in fp64
        sweep_out = [work.data_ptr()] + ([dxg.data_ptr()] if bf16 else [])
        sfx = "_bf16" if bf16 else ""
        with torch.cuda.device(xg.device):
            stream = torch.cuda.current_stream(xg.device).cuda_stream
            launches = (
                lambda: getattr(lib, "fused_lstm_bwd_sweep" + sfx)(
                    w_hh.data_ptr(), cs.data_ptr(), dys.data_ptr(),
                    dc_fin.data_ptr(), *sweep_out, t, b, hid, grp, stream),
                lambda: getattr(lib, "fused_lstm_bwd_dw_partial" + sfx)(
                    ys.data_ptr(), work.data_ptr(), partial.data_ptr(), t, b,
                    hid, grp, stream),
                lambda: getattr(lib, "fused_lstm_bwd_dw_reduce" + sfx)(
                    partial.data_ptr(), dw.data_ptr(), t, b, hid, grp,
                    stream))
            for launch in launches:
                err = launch()
                if err != 0:
                    self._raise(lib, err, "backward", xg)
                self.bwd_launches += 1
                self.bf16_bwd_launches += bf16
        return dxg, dw


lstm_recurrence = FusedLstmRecurrence()
