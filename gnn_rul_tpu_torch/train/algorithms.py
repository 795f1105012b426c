"""Algorithm registry (counterpart of ``gnn_rul_tpu/train/algorithms.py``).

Every method trains with ``Adam(lr, weight_decay)`` and
``loss = MSE(pred, y) + aux_weight * aux``, where ``aux`` is the model's
auxiliary output (graph regularization for LOGO, KL for HAGCN,
reconstruction for STNet and GDAGDL; RGCNU's is unused, weight 0).
LOGO_bearing also steps a MultiStepLR([5, 10, 20, 25], 0.5) per batch.
The table names all 21 methods of the reference; the ported ones are
``models.MODELS`` (the twelve aero-engine methods: FC_STGNN, LOGO, HAGCN,
RGCNU, STAGNN, STFA, GRU_CM, STGNN, DVGTformer, HierCorrPool, ASTGCNN and
ST_Conv), and every other name raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..models import MODELS


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    model_cls: Any
    # hparam key holding the aux-loss weight; "__one__" means weight 1.0;
    # "__zero__" means the aux output exists but is unused (RGCNU).
    aux_weight: Optional[str] = None
    # per-batch MultiStepLR([5, 10, 20, 25], 0.5) (LOGO_bearing only).
    per_batch_multistep: bool = False


# name -> spec fields other than the model class
_TABLE: Dict[str, Dict[str, Any]] = {
    "FC_STGNN": {},
    "HierCorrPool": {},
    "LOGO": {"aux_weight": "theta"},
    "ASTGCNN": {},
    "STFA": {},
    "ST_Conv": {},
    "HAGCN": {"aux_weight": "alpha"},
    "RGCNU": {"aux_weight": "__zero__"},
    "STAGNN": {},
    "DVGTformer": {},
    "GRU_CM": {},
    "STGNN": {},
    "SAGCN": {},
    "STNet": {"aux_weight": "__one__"},
    "ST_GCN": {},
    "GAT_LSTM": {},
    "GDAGDL": {"aux_weight": "__one__"},
    "STMSGCN": {},
    "AGCN_TF": {},
    "LOGO_bearing": {"aux_weight": "theta", "per_batch_multistep": True},
    "HierCorrPool_bearing": {},
}


def get_algorithm_spec(name: str) -> AlgorithmSpec:
    if name not in _TABLE:
        raise NotImplementedError(f"Algorithm not found: {name}")
    if name not in MODELS:
        raise NotImplementedError(
            f"{name} is not ported yet; the port's order of work is in "
            "ROADMAP.md")
    return AlgorithmSpec(MODELS[name], **_TABLE[name])


def resolve_aux_weight(spec: AlgorithmSpec, train_params: Dict) -> float:
    if spec.aux_weight is None or spec.aux_weight == "__zero__":
        return 0.0
    if spec.aux_weight == "__one__":
        return 1.0
    return float(train_params[spec.aux_weight])
