"""Serving: the live model and the exported artifact (counterpart of
``gnn_rul_tpu/export.py``).

:func:`serving_model` builds a model from the hparam bank, loads a
``state_dict`` under the original torch reference's keys (the port's own,
one converted from the JAX package by
:func:`gnn_rul_tpu_torch.compat.from_jax_variables`, or the ``model_dict``
of a reference ``checkpoint.pt``) and returns a :class:`ServingModel`.

:func:`export_serving` traces the same model with ``torch.export`` into an
``ExportedProgram``, weights included, that runs without the model code or
the hparam bank; :func:`save_artifact` writes it with its ``meta`` and
:func:`load_artifact` reads it back as an :class:`ArtifactServingModel`.
The program calls the port's kernels as the registered operators
``gnn_rul_tpu_torch::fused_dot_graph_spmm`` (FC_STGNN),
``::lstm_recurrence`` (LOGO, HAGCN, LOGO_bearing) and ``::fused_gat``
(STAGNN, STFA, GAT_LSTM, GDAGDL), whose
implementation PyTorch's dispatcher picks when the program runs: the
hand-written kernel on the card, the plain version on the CPU. So an
artifact exported on the CPU and loaded with ``device="cuda"`` launches
the kernels; loading imports the kernel modules, which register the
operators, and builds nothing before the first launch.

Call contract, as in the JAX package: input ``(batch, C, L)`` float32,
output ``(batch,)`` float32 normalized-RUL predictions (times
``meta["max_rul"]`` for absolute RUL). The batch is symbolic by default,
so one program serves any batch; with a fixed ``batch_size`` the last
partial batch is padded with its row 0 and the result trimmed, so callers
always get one prediction per input row.

    from gnn_rul_tpu_torch.export import serving_model, load_artifact
    model = serving_model("FC_STGNN", "CMAPSS", "FD001", state_dict,
                          batch_size=100)
    rul = model(x)          # x: (n, 14, 50) -> (n,)
    rul = load_artifact("fc_stgnn_fd001.pt2")(x)

CLI, from a ``checkpoint.pt`` of the port or of the reference:

    python -m gnn_rul_tpu_torch.export --checkpoint run_dir/checkpoint.pt \\
        --GNN_method FC_STGNN --dataset CMAPSS --dataset_id FD001 \\
        --out fc_stgnn_fd001.pt2 [--batch_size 0] [--device cuda]

The methods are ``models.MODELS``, all 21: FC_STGNN, LOGO, HAGCN, RGCNU,
STAGNN, STFA, GRU_CM, STGNN, DVGTformer, HierCorrPool, ASTGCNN, ST_Conv
and the bearing methods HierCorrPool_bearing, ST_GCN, SAGCN, AGCN_TF,
STMSGCN, STNet, GAT_LSTM, GDAGDL and LOGO_bearing (thirteen of them reach
no port kernel; a bearing window is ``(batch, 1, L)``, the raw vibration
signal). SAGCN's and AGCN_TF's spectral features pick a frequency bin,
STNet's graph joins the nodes scoring above 0.7 and GDAGDL's those of
importance above 0, step functions too. LOGO's and LOGO_bearing's
recurrences run along the batch axis and HAGCN's along the batch times the
nodes, so the answer of any of them for a row depends on the other rows
of the forward, padding rows included.
STAGNN's adjacency is ``cov > 0`` per window, HAGCN's pooling keeps the
nodes of top score and STGNN's graph the top similarities of each row:
step functions, so a covariance within rounding of 0, or a score within
rounding of the last one kept, can give another graph, and so another
answer, on the card than on the CPU.

Both run in ``eval()`` under ``torch.inference_mode()``, on the card by
default. With ``precision="bf16"`` both cast the parameters and every
buffer, the BatchNorm statistics included, and the input to bfloat16, as
the JAX package's ``infer`` does, and return fp32; a bf16 artifact holds
the casts and the kernels' bf16 instantiations in its program, with the
same fp32 call contract.
"""

from __future__ import annotations

import argparse
import json
import os
import zipfile
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from .configs import hparams as hparams_bank
from .configs.data_configs import get_dataset_config
# Importing the models imports the kernel modules, which register the
# operators that a loaded program calls (and build nothing before the
# first launch).
from .models import MODELS
from .telemetry import span
from .train.checkpoint import load_checkpoint, load_model_dict
from .train.precision import check_precision

ARTIFACT_FORMAT = "gnn_rul_tpu_torch.artifact.v1"
_META_FILE = "meta.json"  # the artifact's extra file that holds ``meta``
_OUTPUT = "normalized RUL, shape (batch,) float32"


def resolve_device(device: str = "cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default) raises
    where CUDA is absent: the port never falls back to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return dev


def build_model(method: str, dataset: str, dataset_id: Optional[str],
                model_hparams: Optional[Mapping[str, Any]] = None
                ) -> nn.Module:
    """The ``method`` model on the CPU, at ``model_hparams`` or else the
    hparam bank's widths."""
    if method not in MODELS:
        raise NotImplementedError(f"no method {method}")
    return MODELS[method](**(model_hparams or hparams_bank.model_hparams(
        dataset, dataset_id, method)))


def _dtype(precision: str) -> torch.dtype:
    return (torch.bfloat16 if check_precision(precision) == "bf16"
            else torch.float32)


def _check_batch_size(batch_size: Optional[int]) -> None:
    if batch_size is not None and batch_size < 1:
        raise ValueError(f"batch_size must be positive, got {batch_size}")


class ServingModel:
    """``meta`` + ``__call__(x) -> (batch,)`` over a model in eval mode:
    host ``(n, C, L)`` float32 in, host ``(n,)`` float32 out."""

    def __init__(self, model: nn.Module, meta: Dict[str, Any],
                 device: torch.device):
        self.model = model
        self.meta = meta
        self.device = device
        self._batch = meta["input_shape"][0]

    def __call__(self, x) -> np.ndarray:
        # The spans (``telemetry``): the whole call, the host's staging and
        # H->D copy, the forward's ops issued, and the wait for the card
        # with the D->H copy.
        with span("serve.call", first=True), torch.inference_mode():
            _, n_ch, length = self.meta["input_shape"]
            with span("serve.stage_in", first=True):
                x = torch.as_tensor(x, dtype=torch.float32,
                                    device=self.device)
            if x.dim() != 3 or x.shape[1] != n_ch or x.shape[2] != length:
                raise ValueError(f"expected (batch, {n_ch}, {length}), got "
                                 f"{tuple(x.shape)}")
            with span("serve.forward", first=True):
                y = self._forward(x)
            with span("serve.fetch_out", first=True):
                return y.cpu().numpy()

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(batch,)`` on the device: one forward, or fixed-batch forwards
        over ``x`` padded with its row 0, trimmed."""
        if self._batch is None:
            return self.model(x).reshape(-1)
        n = x.shape[0]
        bs = self._batch
        outs = []
        for i in range(0, n, bs):
            chunk = x[i:i + bs]
            if chunk.shape[0] < bs:
                pad = chunk[:1].expand(bs - chunk.shape[0], -1, -1)
                chunk = torch.cat([chunk, pad])
            outs.append(self.model(chunk).reshape(-1)[:n - i])
        return torch.cat(outs)


# The cuDNN RNN calls whose weights an exported program holds apart.
_CUDNN_RNN_MODES = {torch.ops.aten.lstm.input: "LSTM",
                    torch.ops.aten.gru.input: "GRU"}


def _flatten_rnn_weights(module: nn.Module) -> None:
    """Put the weights of each ``aten.lstm`` and ``aten.gru`` call of an
    unlifted program in one cuDNN buffer, as ``flatten_parameters`` does
    for the live ``nn.LSTM`` or ``nn.GRU``. The program holds them as
    separate tensors, and cuDNN would copy them into a buffer at every call
    (and warn each time). A no-op for weights that cuDNN does not take (on
    the CPU)."""
    for node in module.graph.nodes:
        mode = _CUDNN_RNN_MODES.get(node.target)
        if mode is None:
            continue
        (_, _, params, has_biases, num_layers, _, _, bidirectional,
         batch_first) = node.args
        weights = [module.get_parameter(p.target) for p in params]
        if not all(w.is_cuda and torch.backends.cudnn.is_acceptable(w)
                   for w in weights):
            continue
        import torch.backends.cudnn.rnn as cudnn_rnn  # CUDA builds only

        with torch.no_grad():  # rebinds the weights to views of the buffer
            torch._cudnn_rnn_flatten_weight(
                weights, 4 if has_biases else 2, weights[0].shape[1],
                cudnn_rnn.get_cudnn_mode(mode),
                weights[1].shape[1], 0, num_layers, batch_first,
                bidirectional)


class ArtifactServingModel(ServingModel):
    """A loaded artifact: the :class:`ServingModel` contract over the
    exported program (``program``) in place of the model."""

    def __init__(self, program: torch.export.ExportedProgram,
                 meta: Dict[str, Any], device: torch.device):
        module = program.module()
        _flatten_rnn_weights(module)
        super().__init__(module, meta, device)
        self.program = program


def serving_model(method: str, dataset: str, dataset_id: Optional[str],
                  state_dict: Mapping[str, Any], *,
                  batch_size: Optional[int] = None,
                  seq_len: Optional[int] = None,
                  precision: str = "fp32",
                  device: str = "cuda") -> ServingModel:
    """Build ``method`` for ``(dataset, dataset_id)``, load ``state_dict``
    strictly and return a :class:`ServingModel` on ``device``.

    ``batch_size=None`` serves any batch in one forward; a fixed
    ``batch_size`` runs every forward at that batch. ``seq_len`` overrides
    the dataset config's window length, as in :func:`export_serving`
    (XJTU-SY's raw minute is 32,768 samples; the config's 30,768 is the
    reference's stale value). ``precision="bf16"`` serves in bfloat16
    (the module's docstring).
    """
    dtype = _dtype(precision)
    _check_batch_size(batch_size)
    dev = resolve_device(device)
    cfg = get_dataset_config(dataset)
    model = load_model_dict(build_model(method, dataset, dataset_id),
                            state_dict).eval().to(dev)
    if dtype != torch.float32:
        model = _Predict(model.to(dtype), dtype)
    meta = {
        "format": "gnn_rul_tpu_torch.serving.v1",
        "method": method,
        "dataset": dataset,
        "dataset_id": dataset_id,
        "input_shape": [None if batch_size is None else int(batch_size),
                        cfg.input_channels, int(seq_len or cfg.sequence_len)],
        "output": _OUTPUT,
        "precision": precision,
        "device": str(dev),
    }
    return ServingModel(model, meta, dev)


class _Predict(nn.Module):
    """The program's body: the model's eval forward as ``(batch,)``; at a
    ``dtype`` other than fp32 the input cast to it and the output back to
    fp32."""

    def __init__(self, model: nn.Module, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model = model
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return self.model(x).reshape(-1)
        return self.model(x.to(self.dtype)).reshape(-1).float()


def export_serving(method: str, dataset: str, dataset_id: Optional[str],
                   state_dict: Mapping[str, Any], *,
                   batch_size: Optional[int] = None,
                   seq_len: Optional[int] = None,
                   precision: str = "fp32",
                   device: str = "cuda",
                   model_hparams: Optional[Mapping[str, Any]] = None,
                   max_rul: Optional[float] = None,
                   ) -> Tuple[Dict[str, Any], torch.export.ExportedProgram]:
    """Trace ``method``'s eval forward, weights from ``state_dict`` (loaded
    strictly, as :func:`serving_model` loads them), into an
    ``ExportedProgram`` placed on ``device``. Returns ``(meta, program)``.

    ``batch_size=None`` exports a symbolic batch (``Dim("batch", min=1)``:
    one program, any batch); a fixed ``batch_size`` a program of that
    batch. ``seq_len`` overrides the dataset config's window length.
    ``model_hparams`` overrides the hparam bank's (a checkpoint's own).
    ``max_rul`` is recorded in ``meta`` for denormalizing predictions.
    ``precision="bf16"`` exports the bfloat16 forward (the module's
    docstring).

    The trace always runs on the CPU, and a program for another device is
    then moved there (``move_to_device_pass``), as :func:`load_artifact`
    moves one. Traced on CUDA, an eval ``BatchNorm``'s choice of cuDNN,
    which PyTorch makes per call from ``input.size(0) <= 65535``, turns
    into a bound on the symbolic batch (FC_STGNN's encoder normalizes 28
    rows a window: batch <= 2,340), which ``torch.export`` refuses. The
    program keeps ``aten.batch_norm`` itself, so on the card it chooses
    per call, as the live model does.
    """
    dtype = _dtype(precision)
    _check_batch_size(batch_size)
    dev = resolve_device(device)
    cfg = get_dataset_config(dataset)
    length = int(seq_len or cfg.sequence_len)
    model = load_model_dict(
        build_model(method, dataset, dataset_id, model_hparams),
        state_dict).eval().to(dtype)
    # A symbolic batch is traced at 2 rows: an example of 1 row would let
    # the tracer take the batch for the constant 1.
    example = torch.zeros((batch_size or 2, cfg.input_channels, length))
    dynamic = (None if batch_size is not None
               else ({0: torch.export.Dim("batch", min=1)},))
    try:
        with torch.no_grad():
            program = torch.export.export(_Predict(model, dtype), (example,),
                                          dynamic_shapes=dynamic)
    except Exception as e:
        if batch_size is None:
            raise RuntimeError(
                f"symbolic-batch export failed for {method} ({e!r}); "
                f"retry with a fixed batch_size=N") from e
        raise
    if dev.type != "cpu":
        program = move_to_device_pass(program, dev)
    meta = {
        "format": ARTIFACT_FORMAT,
        "method": method,
        "dataset": dataset,
        "dataset_id": dataset_id,
        "input_shape": [None if batch_size is None else int(batch_size),
                        cfg.input_channels, length],
        "output": _OUTPUT,
        "precision": precision,
        "max_rul": max_rul,
        "device": str(dev),
        "torch_version": torch.__version__,
    }
    return meta, program


def save_artifact(path: str, meta: Dict[str, Any],
                  program: torch.export.ExportedProgram) -> str:
    """Write ``program`` with ``meta`` to ``path`` (a ``torch.export``
    archive), through a temporary file renamed into place, so a crash
    mid-write leaves no partial artifact."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.export.save(program, f, extra_files={_META_FILE: json.dumps(meta)})
    os.replace(tmp, path)
    return path


def _read_meta(path: str) -> Dict[str, Any]:
    """The artifact's ``meta``, read before any of its program is;
    ``ValueError`` for a file that is not the port's artifact."""
    not_ours = ValueError(f"{path} is not a {ARTIFACT_FORMAT} serving "
                          "artifact")
    try:
        with zipfile.ZipFile(path) as archive:
            names = [n for n in archive.namelist()
                     if n.endswith(f"/extra/{_META_FILE}")]
            if len(names) != 1:
                raise not_ours
            meta = json.loads(archive.read(names[0]))
    except (zipfile.BadZipFile, json.JSONDecodeError) as e:
        raise not_ours from e
    if not isinstance(meta, dict) or meta.get("format") != ARTIFACT_FORMAT:
        raise not_ours
    return meta


def load_artifact(path: str, device: str = "cuda") -> ArtifactServingModel:
    """Load an artifact of :func:`save_artifact` to serve on ``device``
    (``"cuda"`` by default, which raises where CUDA is absent). A program
    exported on another device (``meta["device"]``) is moved to
    ``device``."""
    dev = resolve_device(device)
    meta = _read_meta(path)
    with open(path, "rb") as f:
        program = torch.export.load(f)
    if torch.device(meta["device"]) != dev:
        program = move_to_device_pass(program, dev)
    return ArtifactServingModel(program, meta, dev)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Export a trained model as a serving artifact")
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint.pt (the port's or the reference's)")
    ap.add_argument("--GNN_method", required=True)
    ap.add_argument("--dataset", required=True,
                    choices=["CMAPSS", "NCMAPSS", "PHM2012", "XJTU_SY"])
    ap.add_argument("--dataset_id", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch_size", type=int, default=0,
                    help="0 = symbolic batch (one artifact, any batch)")
    ap.add_argument("--seq_len", type=int, default=0,
                    help="override the dataset window length")
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                    help="bf16: the program computes in bfloat16 (fp32 in "
                         "and out)")
    ap.add_argument("--max_rul", type=float, default=None,
                    help="recorded in meta for denormalizing predictions")
    ap.add_argument("--device", default="cuda",
                    help="where to export: cuda (default; raises where CUDA "
                         "is absent) or cpu")
    return ap


def main(argv=None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    state_dict, ckpt_hparams = load_checkpoint(args.checkpoint)
    meta, program = export_serving(
        args.GNN_method, args.dataset, args.dataset_id, state_dict,
        batch_size=args.batch_size or None, seq_len=args.seq_len or None,
        precision=args.precision, device=args.device,
        model_hparams=ckpt_hparams, max_rul=args.max_rul)
    save_artifact(args.out, meta, program)
    line = {"artifact": args.out, "bytes": os.path.getsize(args.out), **meta}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
