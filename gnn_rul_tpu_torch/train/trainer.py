"""Experiment runner (counterpart of ``gnn_rul_tpu/train/trainer.py``).

The reference's GNN_RUL_trainer contract (trainer.py:25-262):
  - ``num_runs`` consecutive runs, seed = run index;
  - per epoch, one training epoch and an evaluation of the whole test set;
  - four metrics (Score_v1, Score_v2, MAE, RMSE); the best row is the one
    of least RMSE;
  - per run directory: ``results.csv`` (every best row so far, rewritten
    each epoch), ``results.npz`` (the best predictions), ``logs_run_{id}.log``
    and a final ``checkpoint.pt``; dict test sets (N-CMAPSS per unit,
    PHM2012 per bearing) give artifacts per key;
  - :meth:`Trainer.evaluate_only` evaluates given weights on the test set
    alone and writes the same artifacts under ``<method>_eval``;
  - ``vectorized_runs=True`` trains all the runs at once, one
    :class:`~.vectorized.VectorizedEngine`, with the same artifacts per
    run (each run's ``checkpoint.pt`` is its seed's slice);
  - each run's log gives its edges per sample (``ops/edge_count.py``) and
    each epoch's samples/s and edges/s;
  - ``checkpoint_every=K`` writes ``checkpoint.pt`` after every K-th epoch
    through the :class:`~.checkpoint.AsyncCheckpointer`; ``resume=True``
    restarts each run from its ``checkpoint.pt`` where one exists (weights,
    BatchNorm statistics, Adam, the scheduler, the next epoch), and one
    saved at or past the last epoch is evaluated once. With the keyed
    permutations and dropout (``engine.py``) the resumed run equals the
    uninterrupted one. The vectorized runs write their final checkpoints
    only and do not resume, as the JAX package's;
  - ``precision="bf16"`` trains in bfloat16 on fp32 state
    (``train/precision.py``) and logs the measured guidance;
  - ``mesh`` (``parallel/mesh.py``) trains across the ranks of a
    ``torch.distributed`` job: the ``data`` axis splits each batch's rows
    (``train/engine.py``); a ``model`` axis above 1 splits the wide
    parameters over its ranks (tensor parallelism, ``parallel/mesh.py``,
    ``parallel/model_axis.py``) and routes a hooked method's graph algebra
    through the node-sharded engines (``parallel/graph_partition.py``); a
    method with neither raises, :meth:`Trainer._check_model_axis`. Only
    rank 0 writes artifacts (the CSVs, npz, logs and checkpoints; a
    checkpoint under a split model is gathered whole from the model ranks
    first); with ``resume=True`` rank 0 decides whether a checkpoint exists
    and sends its state and epoch to every rank, and each rank keeps its
    blocks of it;
  - ``profile_dir`` writes a ``torch.profiler`` trace of the epoch after
    the first one run (``utils.profile_trace``): a run of one epoch writes
    none, as in the JAX package.

Runs on ``device="cuda"`` unless told ``device="cpu"``, and raises where
CUDA is absent.
"""

from __future__ import annotations

import contextlib
import csv
import logging
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs import hparams as hparams_bank
from ..configs.data_configs import get_dataset_config
from ..data.loader import DataBundle
from ..export import resolve_device
from ..ops.edge_count import edges_per_sample
from ..parallel import mesh as mesh_lib
from ..parallel.mesh import axis_size, sharded_params
from ..parallel.model_axis import placement_of
from ..parallel.multihost import is_main_process
from ..utils import profile_trace
from .algorithms import get_algorithm_spec
from .checkpoint import (AsyncCheckpointer, load_model_dict, read_payload,
                         restore_payload, save_checkpoint)
from .engine import Engine
from .metrics import calc_metrics
from .precision import bf16_guidance, check_precision, vectorized_guidance
from .vectorized import VectorizedEngine

METRIC_NAMES = ("Score_v1", "Score_v2", "MAE", "RMSE")


def _make_logger(log_dir: str, run_id: int,
                 write: bool = True) -> logging.Logger:
    """Per-run logger to stdout and ``logs_run_{run_id}.log``; a silent
    one where ``write`` is False (a rank other than 0)."""
    name = os.path.join(log_dir, f"logs_run_{run_id}.log")
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    logger.propagate = False
    if not write:
        logger.addHandler(logging.NullHandler())
        return logger
    os.makedirs(log_dir, exist_ok=True)
    fmt = logging.Formatter("%(message)s")
    for handler in (logging.StreamHandler(sys.stdout),
                    logging.FileHandler(name, mode="a")):
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    return logger


class BestTracker:
    """Best-RMSE rows in the reference's CSV schema (trainer.py:196-262)."""

    def __init__(self, save_path: str, key: Optional[Any] = None,
                 write: bool = True):
        self.rows = []  # 4-tuples
        self.save_path = save_path
        # Rank 0 alone writes; every rank tracks the same rows.
        self.write = write
        # The reference writes float keys (N-CMAPSS unit ids) as ints in
        # artifact names (trainer.py:214-217).
        if isinstance(key, float):
            key = int(key)
        self.tag = f"{key}_" if key is not None else ""

    def update(self, metrics, preds, reals, max_rul) -> bool:
        improved = not self.rows or metrics[3] < self.rows[-1][3]
        if improved:
            self.rows.append(tuple(metrics))
            if self.write:
                np.savez(os.path.join(self.save_path,
                                      f"{self.tag}results.npz"),
                         pre=preds, real=reals, max_rul=max_rul)
        if not self.write:
            return improved
        with open(os.path.join(self.save_path, f"{self.tag}results.csv"),
                  "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(METRIC_NAMES)
            writer.writerows(self.rows)
        return improved

    @property
    def best(self):
        return self.rows[-1] if self.rows else None


def check_model_axis(method: str, model: torch.nn.Module,
                     n_model: int) -> None:
    """Refuses a ``model`` axis that would do nothing, as the JAX trainer's
    ``_check_model_axis``: above 1, a method without the node-sharded hook
    raises ValueError where no parameter of ``model`` is wide enough to
    split."""
    if n_model <= 1 or get_algorithm_spec(method).supports_spmm_fn:
        return
    if not sharded_params(model, n_model):
        raise ValueError(
            f"--mesh model={n_model} has no effect for {method}: no kernel "
            f"is wide enough to shard (tp_min_dim={mesh_lib.TP_MIN_DIM}) "
            f"and the model has no spmm_fn hook. Use model=1 (pure data "
            f"parallelism) instead.")


class Trainer:
    """End-to-end experiment runner for one (dataset, sub_id, method)."""

    def __init__(self, method: str, dataset: str, dataset_id: Optional[str],
                 data: DataBundle, save_dir: str = "experiments_logs",
                 experiment_description: str = "exp",
                 run_description: str = "run", num_runs: int = 1,
                 train_params: Optional[Dict] = None,
                 model_hparams: Optional[Dict] = None,
                 num_epochs_override: Optional[int] = None,
                 device: str = "cuda", vectorized_runs: bool = False,
                 precision: str = "fp32", resume: bool = False,
                 checkpoint_every: int = 0, mesh=None,
                 profile_dir: Optional[str] = None):
        self.device = resolve_device(device)
        self.vectorized_runs = vectorized_runs
        self.precision = check_precision(precision)
        self.mesh = mesh
        self.profile_dir = profile_dir
        self.is_main = is_main_process()
        if vectorized_runs and mesh is not None:
            raise ValueError(
                "--vectorized_runs is a single-device capability (it fills "
                "one chip with the seed axis); drop --mesh or the flag")
        if vectorized_runs and resume:
            raise ValueError("vectorized runs do not resume (the runs advance "
                             "in lockstep; resume a run on the sequential "
                             "path)")
        self.resume = resume
        self.checkpoint_every = int(checkpoint_every)
        for msg in ((bf16_guidance(method, dataset)
                     if precision == "bf16" else None),
                    (vectorized_guidance(method, dataset)
                     if vectorized_runs else None)):
            if msg and self.is_main:
                logging.getLogger(__name__).warning(msg)
        self.method = method
        self.dataset = dataset
        self.dataset_id = dataset_id
        self.data = data
        self.num_runs = num_runs
        self.dataset_config = get_dataset_config(dataset)
        self.train_params = dict(train_params or hparams_bank.train_params(
            dataset, dataset_id, method))
        if num_epochs_override:
            self.train_params["num_epochs"] = int(num_epochs_override)
        self.model_hparams = dict(model_hparams or hparams_bank.model_hparams(
            dataset, dataset_id, method))
        self.spec = get_algorithm_spec(method)
        # The method's model without the hook, on the meta device (no
        # weights, no collectives): the model-axis check reads its shapes
        # before any engine is built, on every rank alike, and the edge
        # count runs its forward.
        with torch.device("meta"):
            self._shapes = self._model()
        self._check_model_axis()
        self.exp_log_dir = os.path.join(save_dir, experiment_description,
                                        run_description)
        if self.is_main:
            os.makedirs(self.exp_log_dir, exist_ok=True)

    def _model(self, hooked: bool = False) -> torch.nn.Module:
        """The method's model; ``hooked``: with the node-sharded engine's
        hook where the mesh's model axis is above 1."""
        kwargs = dict(self.model_hparams)
        if hooked and self._hooked():
            from ..parallel.graph_partition import spmm_hook_kwargs
            kwargs.update(spmm_hook_kwargs(self.method, self.mesh))
        return self.spec.model_cls(**kwargs)

    def _hooked(self) -> bool:
        return (axis_size(self.mesh, "model") > 1
                and self.spec.supports_spmm_fn)

    def _build_engine(self, seed: int) -> Engine:
        torch.manual_seed(seed)
        return Engine(self._model(hooked=True), self.spec,
                      self.train_params, seed=seed,
                      device=str(self.device), precision=self.precision,
                      mesh=self.mesh)

    def _check_model_axis(self) -> None:
        check_model_axis(self.method, self._shapes,
                         axis_size(self.mesh, "model"))

    def _tests(self):
        """``(key, x, y, max_rul)`` of each test set (one, or one per key
        of a dict test set)."""
        tests = (self.data.test.items() if self.data.is_dict_test
                 else [(None, self.data.test)])
        for key, (tx, ty) in tests:
            mr = (self.data.max_ruls[key] if isinstance(self.data.max_ruls,
                                                        dict)
                  else self.data.max_ruls)
            yield key, tx, ty.reshape(-1), mr

    def _header(self, run_dir: str, run_id: int, method: str,
                edges: int) -> logging.Logger:
        logger = _make_logger(run_dir, run_id, self.is_main)
        logger.debug("=" * 45)
        logger.debug(f"Dataset: {self.dataset}")
        logger.debug(f"Sub-dataset ID: {self.dataset_id}")
        logger.debug(f"Method: {method}")
        logger.debug(f"Run ID: {run_id}")
        logger.debug(f"Device: {self.device}")
        if self.mesh is not None:
            logger.debug(f"Mesh: data={axis_size(self.mesh, 'data')}, "
                         f"model={axis_size(self.mesh, 'model')} over "
                         f"{dist.get_world_size()} ranks "
                         f"({dist.get_backend()})")
        logger.debug("=" * 45)
        logger.debug(f"Edges per sample: {edges}")
        return logger

    @staticmethod
    def _log_best(logger, key, best) -> None:
        tag = f" {key}," if key is not None else ","
        logger.debug(f"Testing{tag} Score_v1: {best[0]}, Score_v2: "
                     f"{best[1]}, MAE: {best[2]}, RMSE: {best[3]}")

    def _evaluate_and_track(self, engine: Engine, trackers, logger) -> None:
        for key, tx, reals, mr in self._tests():
            preds = engine.evaluate(tx)
            trackers[key].update(calc_metrics(preds, reals, mr), preds,
                                 reals, mr)
            self._log_best(logger, key, trackers[key].best)

    def evaluate_only(self, state_dict: Dict[str, Any]) -> Dict:
        """Evaluate ``state_dict`` (the reference's keys, as a port or
        reference ``checkpoint.pt``'s ``model_dict`` holds them, with or
        without the ``model.`` prefix; loaded strictly) on the test set, at
        the trainer's hparams and eval batch. Writes ``results.csv``,
        ``results.npz`` and the log under ``<method>_eval`` and returns
        ``{key_or_None: (Score_v1, Score_v2, MAE, RMSE)}``, as the JAX
        ``Trainer.evaluate_only`` does."""
        run_dir = os.path.join(self.exp_log_dir, f"{self.method}_eval")
        logger = _make_logger(run_dir, 0, self.is_main)
        model = load_model_dict(self._model(hooked=True),
                                state_dict).eval().to(self.device)
        engine = Engine(model, self.spec, self.train_params, seed=0,
                        device=str(self.device), precision=self.precision,
                        mesh=self.mesh)
        trackers = self._trackers(run_dir)
        self._evaluate_and_track(engine, trackers, logger)
        return {k: t.best for k, t in trackers.items()}

    def _trackers(self, run_dir: str) -> Dict:
        keys = list(self.data.test) if self.data.is_dict_test else [None]
        return {k: BestTracker(run_dir, key=k, write=self.is_main)
                for k in keys}

    def _resume_from(self, ckpt_path: str, engine: Engine) -> int:
        """The first epoch to train: 1, or the one after the checkpoint's
        when it exists. Under a mesh rank 0 decides whether it exists and
        reads it, and every rank restores rank 0's payload."""
        payload = None
        if self.is_main and os.path.exists(ckpt_path):
            payload = read_payload(ckpt_path)
        if self.mesh is not None:
            box = [payload]
            dist.broadcast_object_list(box, src=0)
            payload = box[0]
        if payload is None:
            return 1
        return restore_payload(payload, engine.model, engine.optimizer,
                               engine.scheduler, ckpt_path) + 1

    def train(self) -> Dict[int, Dict]:
        """Run every seed; returns ``{run_id: {key_or_None: best 4-tuple}}``."""
        if self.vectorized_runs:
            return self._train_vectorized()
        ckptr = AsyncCheckpointer()
        try:
            return {run_id: self._train_run(run_id, ckptr)
                    for run_id in range(self.num_runs)}
        finally:
            ckptr.close()

    def _save(self, save, path: str, engine: Engine, epoch: int,
              run_id: int):
        """A checkpoint by ``save``, written by rank 0. Where the model
        is split over the model axis every rank calls this (the payload
        gathers the split parameters); elsewhere rank 0 alone."""
        if not (self.is_main or placement_of(engine.model) is not None):
            return None
        return save(path, engine.model, engine.optimizer, epoch=epoch,
                    run_id=run_id, hparams=self.model_hparams,
                    train_params=self.train_params,
                    scheduler=engine.scheduler, precision=self.precision,
                    write=self.is_main)

    def _train_run(self, run_id: int, ckptr: AsyncCheckpointer) -> Dict:
        """One sequential run; returns ``{key_or_None: best 4-tuple}``."""
        num_epochs = int(self.train_params["num_epochs"])
        shuffle = self.dataset_config.shuffle
        n_train = int(self.data.train_x.shape[0])
        run_dir = os.path.join(self.exp_log_dir,
                               f"{self.method}_run_{run_id}")
        ckpt_path = os.path.join(run_dir, "checkpoint.pt")
        engine = self._build_engine(seed=run_id)
        # Static per (method, hparams): one forward on the meta device (of
        # the model without the hook, whose collectives need real tensors).
        edges = edges_per_sample(self._shapes, self.data.train_x)
        logger = self._header(run_dir, run_id, self.method, edges)
        start_epoch = 1
        if self.resume:
            start_epoch = self._resume_from(ckpt_path, engine)
            if start_epoch > 1:
                logger.debug(f"Resumed from epoch {start_epoch - 1}")
        trackers = self._trackers(run_dir)
        for epoch in range(start_epoch, num_epochs + 1):
            profiled = (self.profile_dir is not None and self.is_main
                        and epoch == start_epoch + 1)
            t0 = time.perf_counter()
            with (profile_trace(self.profile_dir) if profiled
                  else contextlib.nullcontext()):
                loss = engine.run_epoch(self.data.train_x, self.data.train_y,
                                        epoch, shuffle=shuffle)
            dt = time.perf_counter() - t0  # the loss read synchronised
            if profiled:
                logger.debug(f"Profiler trace of epoch {epoch} -> "
                             f"{self.profile_dir}")
            sps = n_train / max(dt, 1e-9)
            logger.debug(f"[Epoch : {epoch}/{num_epochs}]")
            logger.debug(f"loss\t: {loss:2.4f}\t({dt:.2f}s | "
                         f"{sps:,.0f} samples/s | {sps * edges:,.3g} "
                         f"edges/s)")
            self._evaluate_and_track(engine, trackers, logger)
            logger.debug("-" * 37)
            if self.checkpoint_every and epoch % self.checkpoint_every == 0:
                self._save(ckptr.save, ckpt_path, engine, epoch, run_id)
        if start_epoch > num_epochs:
            # A checkpoint at or past the last epoch: nothing to train;
            # its weights are evaluated once for the run's artifacts.
            self._evaluate_and_track(engine, trackers, logger)
        ckptr.wait()
        self._save(save_checkpoint, ckpt_path, engine,
                   max(num_epochs, start_epoch - 1), run_id)
        return {k: t.best for k, t in trackers.items()}

    def _train_vectorized(self) -> Dict[int, Dict]:
        """Every run at once, seed = run index: one epoch of all seeds a
        step at a time and one evaluation of all seeds, with each run's own
        directory, log, best rows, ``results.csv/npz`` and final
        ``checkpoint.pt`` (its seed's slice of the state)."""
        seeds = list(range(self.num_runs))
        engine = VectorizedEngine(self._model, self.spec, self.train_params,
                                  seeds, device=str(self.device),
                                  precision=self.precision)
        edges = edges_per_sample(self._shapes, self.data.train_x)
        keys = list(self.data.test) if self.data.is_dict_test else [None]
        run_dirs, loggers, trackers = [], [], []
        for run_id in seeds:
            run_dirs.append(os.path.join(self.exp_log_dir,
                                         f"{self.method}_run_{run_id}"))
            loggers.append(self._header(
                run_dirs[-1], run_id,
                f"{self.method} (vectorized over {self.num_runs} seeds)",
                edges))
            trackers.append({k: BestTracker(run_dirs[-1], key=k)
                             for k in keys})
        num_epochs = int(self.train_params["num_epochs"])
        shuffle = self.dataset_config.shuffle
        n_train = int(self.data.train_x.shape[0])
        for epoch in range(1, num_epochs + 1):
            t0 = time.perf_counter()
            losses = engine.run_epoch(self.data.train_x, self.data.train_y,
                                      epoch, shuffle=shuffle)
            dt = time.perf_counter() - t0  # the losses read synchronised
            sps = n_train * self.num_runs / max(dt, 1e-9)
            for run_id in seeds:
                loggers[run_id].debug(f"[Epoch : {epoch}/{num_epochs}]")
                loggers[run_id].debug(
                    f"loss\t: {losses[run_id]:2.4f}\t({dt:.2f}s | "
                    f"{sps:,.0f} samples/s all-seeds | {sps * edges:,.3g} "
                    f"edges/s all-seeds)")
            for key, tx, reals, mr in self._tests():
                preds = engine.evaluate(tx)                 # (S, n)
                for run_id in seeds:
                    tracker = trackers[run_id][key]
                    tracker.update(calc_metrics(preds[run_id], reals, mr),
                                   preds[run_id], reals, mr)
                    self._log_best(loggers[run_id], key, tracker.best)
            for run_id in seeds:
                loggers[run_id].debug("-" * 37)
        for run_id in seeds:
            model = self._model()
            model.load_state_dict(engine.slice_state(run_id))
            optimizer = torch.optim.Adam(model.parameters())
            optimizer.load_state_dict(engine.slice_optimizer(run_id))
            save_checkpoint(os.path.join(run_dirs[run_id], "checkpoint.pt"),
                            model, optimizer, epoch=num_epochs, run_id=run_id,
                            hparams=self.model_hparams,
                            train_params=self.train_params,
                            precision=self.precision)
        return {run_id: {k: t.best for k, t in trackers[run_id].items()}
                for run_id in seeds}
