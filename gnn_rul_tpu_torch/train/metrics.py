"""Evaluation metrics (copy of ``gnn_rul_tpu/train/metrics.py``).

The reference's formulas (utils.py:136-201), vectorized in numpy. Every
function takes normalized predictions and labels (y in [0, 1]) and, where
it reports cycles, the denormalizing ``max_rul``.
"""

from __future__ import annotations

import numpy as np


def scoring_function(predicted, real, max_rul):
    """PHM08-style asymmetric exponential score, (sum, mean).

    Under-prediction (real > pred): exp(delta*max_rul/13) - 1;
    over-prediction (real <= pred): exp(delta*max_rul/10) - 1.
    Reference utils.py:136-146.
    """
    predicted = np.asarray(predicted, dtype=np.float64)
    real = np.asarray(real, dtype=np.float64)
    delta = (real - predicted) * max_rul
    under = np.exp(delta / 13.0) - 1.0
    over = np.exp(-delta / 10.0) - 1.0
    score = float(np.sum(np.where(real > predicted, under, over)))
    return score, score / predicted.shape[0]


def scoring_function_v2(predicted, real):
    """Percent-error exponential score (mean). Reference utils.py:157-169."""
    predicted = np.asarray(predicted, dtype=np.float64)
    real = np.asarray(real, dtype=np.float64)
    err = ((real - predicted) / (real + 1e-8)) * 100.0
    early = np.exp(-np.log(0.5) * (err / 5.0))   # err <= 0
    late = np.exp(np.log(0.5) * (err / 20.0))    # err > 0
    return float(np.mean(np.where(err <= 0, early, late)))


def rmse_value(predicted, real, max_rul):
    predicted = np.asarray(predicted, dtype=np.float64)
    real = np.asarray(real, dtype=np.float64)
    return float(np.sqrt(np.mean((real - predicted) ** 2)) * max_rul)


def mae_value(predicted, real, max_rul):
    predicted = np.asarray(predicted, dtype=np.float64)
    real = np.asarray(real, dtype=np.float64)
    return float(np.mean(np.abs(real - predicted)) * max_rul)


def calc_metrics(pred_labels, true_labels, max_rul):
    """(Score_v1, Score_v2, MAE, RMSE): the reference's _calc_metrics,
    utils.py:191-201."""
    s1, _ = scoring_function(pred_labels, true_labels, max_rul)
    s2 = scoring_function_v2(pred_labels, true_labels)
    mae = mae_value(pred_labels, true_labels, max_rul)
    rmse = rmse_value(pred_labels, true_labels, max_rul)
    return s1, s2, mae, rmse


def calc_metrics_aeroengine(pred_labels, true_labels, max_rul):
    """(Score, AvgScore, RMSE): the reference's utils.py:171-178."""
    s, avg = scoring_function(pred_labels, true_labels, max_rul)
    return s, avg, rmse_value(pred_labels, true_labels, max_rul)


def calc_metrics_bearing(pred_labels, true_labels, max_rul):
    """(Score_v2, MAE, RMSE): the reference's utils.py:180-189."""
    s = scoring_function_v2(pred_labels, true_labels)
    return (s, mae_value(pred_labels, true_labels, max_rul),
            rmse_value(pred_labels, true_labels, max_rul))
