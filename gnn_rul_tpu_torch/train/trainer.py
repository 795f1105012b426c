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
    alone and writes the same artifacts under ``<method>_eval``.

Runs on ``device="cuda"`` unless told ``device="cpu"``, and raises where
CUDA is absent. Periodic checkpoints, resume, seed-parallel runs, meshes,
bf16, profiling and the edges/s counter are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import csv
import logging
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs import hparams as hparams_bank
from ..configs.data_configs import get_dataset_config
from ..data.loader import DataBundle
from ..export import resolve_device
from .algorithms import get_algorithm_spec
from .checkpoint import load_model_dict, save_checkpoint
from .engine import Engine
from .metrics import calc_metrics

METRIC_NAMES = ("Score_v1", "Score_v2", "MAE", "RMSE")


def _make_logger(log_dir: str, run_id: int) -> logging.Logger:
    """Per-run logger to stdout and ``logs_run_{run_id}.log``."""
    name = os.path.join(log_dir, f"logs_run_{run_id}.log")
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    logger.propagate = False
    os.makedirs(log_dir, exist_ok=True)
    fmt = logging.Formatter("%(message)s")
    for handler in (logging.StreamHandler(sys.stdout),
                    logging.FileHandler(name, mode="a")):
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    return logger


class BestTracker:
    """Best-RMSE rows in the reference's CSV schema (trainer.py:196-262)."""

    def __init__(self, save_path: str, key: Optional[Any] = None):
        self.rows = []  # 4-tuples
        self.save_path = save_path
        # The reference writes float keys (N-CMAPSS unit ids) as ints in
        # artifact names (trainer.py:214-217).
        if isinstance(key, float):
            key = int(key)
        self.tag = f"{key}_" if key is not None else ""

    def update(self, metrics, preds, reals, max_rul) -> bool:
        improved = not self.rows or metrics[3] < self.rows[-1][3]
        if improved:
            self.rows.append(tuple(metrics))
            np.savez(os.path.join(self.save_path, f"{self.tag}results.npz"),
                     pre=preds, real=reals, max_rul=max_rul)
        with open(os.path.join(self.save_path, f"{self.tag}results.csv"),
                  "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(METRIC_NAMES)
            writer.writerows(self.rows)
        return improved

    @property
    def best(self):
        return self.rows[-1] if self.rows else None


class Trainer:
    """End-to-end experiment runner for one (dataset, sub_id, method)."""

    def __init__(self, method: str, dataset: str, dataset_id: Optional[str],
                 data: DataBundle, save_dir: str = "experiments_logs",
                 experiment_description: str = "exp",
                 run_description: str = "run", num_runs: int = 1,
                 train_params: Optional[Dict] = None,
                 model_hparams: Optional[Dict] = None,
                 num_epochs_override: Optional[int] = None,
                 device: str = "cuda"):
        self.device = resolve_device(device)
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
        self.exp_log_dir = os.path.join(save_dir, experiment_description,
                                        run_description)
        os.makedirs(self.exp_log_dir, exist_ok=True)

    def _build_engine(self, seed: int) -> Engine:
        torch.manual_seed(seed)
        model = self.spec.model_cls(**self.model_hparams)
        return Engine(model, self.spec, self.train_params, seed=seed,
                      device=str(self.device))

    def _evaluate_and_track(self, engine: Engine, trackers, logger) -> None:
        tests = (self.data.test.items() if self.data.is_dict_test
                 else [(None, self.data.test)])
        for key, (tx, ty) in tests:
            preds = engine.evaluate(tx)
            reals = ty.reshape(-1)
            mr = (self.data.max_ruls[key] if isinstance(self.data.max_ruls,
                                                        dict)
                  else self.data.max_ruls)
            trackers[key].update(calc_metrics(preds, reals, mr), preds,
                                 reals, mr)
            b = trackers[key].best
            tag = f" {key}," if key is not None else ","
            logger.debug(f"Testing{tag} Score_v1: {b[0]}, Score_v2: {b[1]}, "
                         f"MAE: {b[2]}, RMSE: {b[3]}")

    def evaluate_only(self, state_dict: Dict[str, Any]) -> Dict:
        """Evaluate ``state_dict`` (the reference's keys, as a port or
        reference ``checkpoint.pt``'s ``model_dict`` holds them, with or
        without the ``model.`` prefix; loaded strictly) on the test set, at
        the trainer's hparams and eval batch. Writes ``results.csv``,
        ``results.npz`` and the log under ``<method>_eval`` and returns
        ``{key_or_None: (Score_v1, Score_v2, MAE, RMSE)}``, as the JAX
        ``Trainer.evaluate_only`` does."""
        run_dir = os.path.join(self.exp_log_dir, f"{self.method}_eval")
        logger = _make_logger(run_dir, 0)
        model = load_model_dict(self.spec.model_cls(**self.model_hparams),
                                state_dict).eval().to(self.device)
        engine = Engine(model, self.spec, self.train_params, seed=0,
                        device=str(self.device))
        keys = list(self.data.test) if self.data.is_dict_test else [None]
        trackers = {k: BestTracker(run_dir, key=k) for k in keys}
        self._evaluate_and_track(engine, trackers, logger)
        return {k: t.best for k, t in trackers.items()}

    def train(self) -> Dict[int, Dict]:
        """Run every seed; returns ``{run_id: {key_or_None: best 4-tuple}}``."""
        all_results = {}
        num_epochs = int(self.train_params["num_epochs"])
        shuffle = self.dataset_config.shuffle
        n_train = int(self.data.train_x.shape[0])
        for run_id in range(self.num_runs):
            run_dir = os.path.join(self.exp_log_dir,
                                   f"{self.method}_run_{run_id}")
            logger = _make_logger(run_dir, run_id)
            logger.debug("=" * 45)
            logger.debug(f"Dataset: {self.dataset}")
            logger.debug(f"Sub-dataset ID: {self.dataset_id}")
            logger.debug(f"Method: {self.method}")
            logger.debug(f"Run ID: {run_id}")
            logger.debug(f"Device: {self.device}")
            logger.debug("=" * 45)

            engine = self._build_engine(seed=run_id)
            keys = list(self.data.test) if self.data.is_dict_test else [None]
            trackers = {k: BestTracker(run_dir, key=k) for k in keys}
            for epoch in range(1, num_epochs + 1):
                t0 = time.perf_counter()
                loss = engine.run_epoch(self.data.train_x, self.data.train_y,
                                        epoch, shuffle=shuffle)
                dt = time.perf_counter() - t0  # the loss read synchronised
                logger.debug(f"[Epoch : {epoch}/{num_epochs}]")
                logger.debug(f"loss\t: {loss:2.4f}\t({dt:.2f}s | "
                             f"{n_train / max(dt, 1e-9):,.0f} samples/s)")
                self._evaluate_and_track(engine, trackers, logger)
                logger.debug("-" * 37)
            save_checkpoint(os.path.join(run_dir, "checkpoint.pt"),
                            engine.model, engine.optimizer, epoch=num_epochs,
                            run_id=run_id, hparams=self.model_hparams,
                            train_params=self.train_params)
            all_results[run_id] = {k: t.best for k, t in trackers.items()}
        return all_results
