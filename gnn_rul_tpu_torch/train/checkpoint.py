"""Checkpoints in the reference's ``checkpoint.pt`` layout, periodic and
asynchronous, and resume (counterpart of
``gnn_rul_tpu/train/checkpoint.py``).

The payload is ``{"hparams", "train_params", "model_dict", "optimizer",
"epoch", "run_id", "scheduler", "precision"}``, every tensor on the CPU.
``model_dict`` carries the reference's keys, so
``gnn_rul_tpu_torch.export.serving_model`` loads it and so does the JAX
package's ``import_torch_checkpoint``; ``scheduler`` is LOGO_bearing's
MultiStepLR state (None elsewhere). The file is written to a temporary
name and renamed, so a crash mid-write leaves the previous checkpoint.
:func:`load_checkpoint` reads a checkpoint of the port or of the
reference, :func:`load_model_dict` loads its ``model_dict`` into a model,
the keys as either writes them, and :func:`restore` puts a run's model,
Adam and scheduler back for ``--resume``.

:class:`AsyncCheckpointer` writes periodic checkpoints off the training
thread. JAX hands its immutable arrays to the writer; torch's tensors are
rewritten in place by the next ``optimizer.step()``, so :meth:`save`
snapshots them first, on the training thread: a copy of each CUDA tensor
into pinned host memory on a side stream that waits for the current
stream, the current stream then waiting for the copies (so no later
kernel overwrites a tensor before it is copied) and an event recorded
after them; a CPU tensor is cloned. The writer thread waits on the event
and runs ``torch.save``; the training thread never waits for the disk.

A model whose parameters are split over a mesh's model axis
(``parallel/model_axis.py``) is saved whole: the payload gathers each
split parameter and its Adam moments from the model ranks (every rank
builds it, on the training thread, and rank 0 alone writes, ``write``),
so the file is the one a single process writes. Restoring it into such a
model keeps this rank's blocks.
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..nn.tcn import TemporalConvNet
from ..parallel.model_axis import placement_of


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _payload(model: nn.Module, optimizer: torch.optim.Optimizer, scheduler,
             epoch: int, run_id: int, hparams: Dict[str, Any],
             train_params: Dict[str, Any], precision: str) -> Dict[str, Any]:
    placement = placement_of(model)
    if placement is None:
        model_dict, optim = model.state_dict(), optimizer.state_dict()
    else:   # collectives: every rank of the model group builds it
        model_dict = placement.whole_state_dict(model)
        optim = placement.whole_optimizer_state(model, optimizer)
    return {
        "hparams": dict(hparams),
        "train_params": dict(train_params),
        "model_dict": model_dict,
        "optimizer": optim,
        "epoch": int(epoch),
        "run_id": int(run_id),
        "scheduler": scheduler.state_dict() if scheduler is not None else None,
        "precision": precision,
    }


def _write(path: str, payload: Dict[str, Any]) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(path: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer, *, epoch: int,
                    run_id: int, hparams: Dict[str, Any],
                    train_params: Dict[str, Any], scheduler=None,
                    precision: str = "fp32", write: bool = True
                    ) -> Optional[str]:
    """Writes the checkpoint now, on the calling thread; with ``write``
    False only builds its payload (a model rank's share of the gathers)."""
    payload = _to_cpu(_payload(model, optimizer, scheduler, epoch, run_id,
                               hparams, train_params, precision))
    return _write(path, payload) if write else None


class _Snapshot:
    """Host copies of a payload's tensors, complete once ``ready()``
    returns."""

    def __init__(self, payload: Dict[str, Any]):
        self.event: Optional[torch.cuda.Event] = None
        self._side: Optional[torch.cuda.Stream] = None
        self.payload = self._copy(payload)
        if self._side is not None:
            self.event = torch.cuda.Event()
            self.event.record(self._side)
            # Later work on the current stream (the next optimizer step)
            # waits for the copies, so none overwrites a tensor first.
            torch.cuda.current_stream().wait_stream(self._side)

    def _copy(self, obj):
        if isinstance(obj, torch.Tensor):
            t = obj.detach()
            if not t.is_cuda:
                return t.clone()
            if self._side is None:
                self._side = torch.cuda.Stream(device=t.device)
                self._side.wait_stream(torch.cuda.current_stream(t.device))
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            with torch.cuda.stream(self._side):
                host.copy_(t, non_blocking=True)
            t.record_stream(self._side)
            return host
        if isinstance(obj, dict):
            return {k: self._copy(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._copy(v) for v in obj)
        return obj

    def ready(self) -> Dict[str, Any]:
        if self.event is not None:
            self.event.synchronize()
        return self.payload


class AsyncCheckpointer:
    """Periodic checkpoints written by one background thread.

    :meth:`save` snapshots the run's state on the training thread (see
    the module's docstring) and returns; the write runs on the thread. At
    most one write is in flight: a save first waits out the one before,
    so checkpoints land in order and host memory stays bounded.
    :meth:`wait` and :meth:`close` re-raise a writer's error."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="gnnrul-ckpt")
        self._inflight: Optional[Future] = None

    def save(self, path: str, model: nn.Module,
             optimizer: torch.optim.Optimizer, *, epoch: int, run_id: int,
             hparams: Dict[str, Any], train_params: Dict[str, Any],
             scheduler=None, precision: str = "fp32",
             write: bool = True) -> Optional[Future]:
        """Snapshots the checkpoint and hands its write to the thread; with
        ``write`` False builds the payload only (a model rank's share of
        the gathers) and returns None."""
        self.wait()
        payload = _payload(model, optimizer, scheduler, epoch, run_id,
                           hparams, train_params, precision)
        if not write:
            return None
        snap = _Snapshot(payload)
        self._inflight = self._pool.submit(
            lambda: _write(path, snap.ready()))
        return self._inflight

    def wait(self) -> None:
        """Blocks until the write in flight, if any, is on disk; re-raises
        its error."""
        if self._inflight is not None:
            fut, self._inflight = self._inflight, None
            fut.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Optional[Dict]]:
    """``(state_dict, model_hparams or None)`` from a ``checkpoint.pt``
    of the port (:func:`save_checkpoint`) or of the reference, which share
    one layout; a bare state_dict is taken as it is."""
    if path.endswith(".pkl"):
        raise ValueError(
            f"{path}: the port does not read the JAX package's "
            "checkpoint.pkl; convert its variables with "
            "gnn_rul_tpu_torch.compat.from_jax_variables and pass the "
            "state_dict to export_serving (ROADMAP.md)")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if "model_dict" not in payload:
        return payload, None
    return payload["model_dict"], payload.get("hparams")


def load_model_dict(model: nn.Module,
                    state_dict: Mapping[str, Any]) -> nn.Module:
    """Loads ``state_dict`` (the reference's keys) into ``model`` strictly
    and returns the model."""
    # A reference checkpoint's model_dict may be the algorithm's state_dict,
    # whose model keys carry a "model." prefix.
    if any(k.startswith("model.") for k in state_dict):
        keys = {k[len("model."):]: v for k, v in state_dict.items()
                if k.startswith("model.")}
    else:
        keys = dict(state_dict)
    # The reference's TemporalConvNet builds weight-normed net0/net1
    # submodules that its forward never calls, and ST_Conv layer-2 modules
    # (the model's UNCALLED); their keys are dropped, and only theirs, so
    # that any other unexpected key still fails the strict load (as the JAX
    # importer reads only the keys it names).
    dead = tuple(f"{name}.{sub}." for name, m in model.named_modules()
                 if isinstance(m, TemporalConvNet) for sub in ("net0", "net1"))
    dead += tuple(getattr(model, "UNCALLED", ()))
    keys = {k: v for k, v in keys.items() if not k.startswith(dead)}
    placement = placement_of(model)
    if placement is not None:
        keys = placement.local_state_dict(keys)
    model.load_state_dict(keys, strict=True)
    return model


def restore(path: str, model: nn.Module, optimizer: torch.optim.Optimizer,
            scheduler=None) -> int:
    """Puts the run of ``path`` (a checkpoint of :func:`save_checkpoint` or
    :class:`AsyncCheckpointer`) back into ``model``, ``optimizer`` and
    ``scheduler``; returns the epoch it was saved after."""
    return restore_payload(read_payload(path), model, optimizer, scheduler,
                           path)


def read_payload(path: str) -> Dict[str, Any]:
    """The checkpoint at ``path``, every tensor on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_payload(payload: Dict[str, Any], model: nn.Module,
                    optimizer: torch.optim.Optimizer, scheduler=None,
                    path: str = "the checkpoint") -> int:
    """:func:`restore` from a checkpoint already read (:func:`read_payload`,
    or one that rank 0 read and broadcast to the job)."""
    load_model_dict(model, payload["model_dict"])
    placement = placement_of(model)
    optimizer.load_state_dict(
        payload["optimizer"] if placement is None
        else placement.local_optimizer_state(model, payload["optimizer"]))
    if scheduler is not None:
        if payload.get("scheduler") is None:
            raise ValueError(f"{path} holds no scheduler state")
        scheduler.load_state_dict(payload["scheduler"])
    return int(payload["epoch"])
