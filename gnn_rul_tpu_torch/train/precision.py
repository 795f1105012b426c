"""bf16 compute with fp32 state, and measured guidance on when to use it
(counterpart of ``gnn_rul_tpu/train/precision.py``).

``--precision bf16`` runs the forward and the backward in bfloat16: the
parameters, the model's constant buffers (FC_STGNN's decay masks and
positional encoding, DVGTformer's, the attention models' fixed graphs)
and the input are cast to bfloat16 inside each step, differentiably, so
the gradients flow back into the fp32 master parameters; Adam's state,
the loss and the metrics stay fp32, and so do the BatchNorm running
statistics (``nn/basic.py`` normalises a bfloat16 input in fp32 and
updates them in fp32), as the JAX engine keeps its ``batch_stats``.

The guidance tables hold ratios measured on the port's own card, each
with the card's name and power limit: the JAX package's TPU tables are
not carried over. A method without a row gets no warning.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Set

import torch
from torch import nn
from torch.func import functional_call

WARN_THRESHOLD = 0.95

# (method, dataset) -> bf16/fp32 training samples/s of one FD001 epoch on
# the card: (ratio, "card name, power limit"); chip_smoke.py's phase
# "bf16" (_bf16_train_times), PERF.md §5. A bf16 step adds a cast of every
# parameter and constant, forward and backward, to steps that leave the
# card idle most of the time, and the kernels' bf16 instantiations stage
# by plain loads: slower on all three.
_H100 = "NVIDIA H100 80GB HBM3, 700.00 W"
BF16_MEASURED_GAIN: Dict[tuple, tuple] = {
    ("FC_STGNN", "CMAPSS"): (0.8038, _H100),
    ("LOGO", "CMAPSS"): (0.8285, _H100),
    ("STAGNN", "CMAPSS"): (0.7248, _H100),
}

# (method, dataset) -> samples/s of one --vectorized_runs epoch against
# the sequential epochs, where measured below 1 on the card: (ratio, "card
# name, power limit"). Every ratio measured so far is above 1 (PERF.md §5,
# chip_smoke.py's phase "vectorized"), so no method has a row.
VECTORIZED_MEASURED_GAIN: Dict[tuple, tuple] = {}


def bf16_guidance(method: str, dataset: str) -> Optional[str]:
    """A warning where bf16 is measured slower than fp32 on this method and
    dataset (below ``WARN_THRESHOLD``), else None."""
    row = BF16_MEASURED_GAIN.get((method, dataset))
    if row is None or row[0] >= WARN_THRESHOLD:
        return None
    return (f"--precision bf16 is measured at {row[0]:.2f}x fp32's training "
            f"samples/s on {method}/{dataset} ({row[1]}, PERF.md); fp32 is "
            f"faster here.")


def vectorized_guidance(method: str, dataset: str) -> Optional[str]:
    """A warning where --vectorized_runs is measured slower than sequential
    runs on this method and dataset, else None."""
    row = VECTORIZED_MEASURED_GAIN.get((method, dataset))
    if row is None or row[0] >= 1.0:
        return None
    return (f"--vectorized_runs is measured at {row[0]:.2f}x the sequential "
            f"runs' wall clock on {method}/{dataset} ({row[1]}, PERF.md); "
            f"sequential runs are faster here.")


def check_precision(precision: str) -> str:
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"precision must be 'fp32' or 'bf16', got "
                         f"{precision!r}")
    return precision


def cast_buffer_names(model: nn.Module) -> Set[str]:
    """The floating buffers that a bf16 forward casts: every one but the
    BatchNorm running statistics, which stay fp32."""
    keep = {f"{prefix}.{name}" if prefix else name
            for prefix, m in model.named_modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for name in ("running_mean", "running_var")}
    return {k for k, b in model.named_buffers()
            if b.is_floating_point() and k not in keep}


def to_bf16(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Differentiable bf16 copies of the floating tensors of ``tensors``."""
    return {k: v.to(torch.bfloat16) if v.is_floating_point() else v
            for k, v in tensors.items()}


def to_fp32(out: Any) -> Any:
    """The model's output (a tensor or a tuple of them) in fp32."""
    if isinstance(out, tuple):
        return tuple(to_fp32(o) for o in out)
    return out.float() if isinstance(out, torch.Tensor) else out


def bf16_forward(model: nn.Module, params: Dict[str, torch.Tensor],
                 buffers: Dict[str, torch.Tensor], cast: Set[str],
                 x: torch.Tensor) -> Any:
    """``model``'s forward at bf16 on ``params`` and ``buffers`` (fp32, the
    model's own or stacked ones under vmap), differentiable in the
    parameters; the output in fp32. The buffers named in ``cast``
    (:func:`cast_buffer_names`) are cast, and in eval mode every buffer,
    the BatchNorm statistics included, as the JAX engine's eval casts its
    ``batch_stats``; in training those stay fp32 and are updated in
    place."""
    training = model.training
    state = {k: (b.to(torch.bfloat16) if b.is_floating_point()
                 and (k in cast or not training) else b)
             for k, b in buffers.items()}
    return to_fp32(functional_call(model, (to_bf16(params), state),
                                   (x.to(torch.bfloat16),)))
