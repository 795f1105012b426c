"""Algorithm registry (counterpart of ``gnn_rul_tpu/train/algorithms.py``).

Every method trains with ``Adam(lr, weight_decay)`` and
``loss = MSE(pred, y) + aux_weight * aux``, where ``aux`` is the model's
auxiliary output (graph regularization for LOGO, KL for HAGCN,
reconstruction for STNet and GDAGDL; RGCNU's is unused, weight 0).
LOGO_bearing also steps a MultiStepLR([5, 10, 20, 25], 0.5) per batch.
Seven methods take a node-sharded engine for their dense ``(N, N)`` graph
algebra (``supports_spmm_fn``: a ``spmm_fn`` or ``gat_fn`` constructor
keyword, ``parallel/graph_partition.py::spmm_hook_kwargs``), as in the JAX
package.
The table names all 21 methods of the reference, each ported
(``models.MODELS``: the twelve aero-engine methods and the nine bearing
methods); any other name raises.
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
    # the model takes the node-sharded engine's hook (spmm_fn or gat_fn).
    supports_spmm_fn: bool = False


# name -> spec fields other than the model class
_TABLE: Dict[str, Dict[str, Any]] = {
    "FC_STGNN": {"supports_spmm_fn": True},
    "HierCorrPool": {"supports_spmm_fn": True},
    "LOGO": {"aux_weight": "theta", "supports_spmm_fn": True},
    "ASTGCNN": {},
    "STFA": {"supports_spmm_fn": True},
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
    "GAT_LSTM": {"supports_spmm_fn": True},
    "GDAGDL": {"aux_weight": "__one__"},
    "STMSGCN": {},
    "AGCN_TF": {},
    "LOGO_bearing": {"aux_weight": "theta", "per_batch_multistep": True,
                     "supports_spmm_fn": True},
    "HierCorrPool_bearing": {"supports_spmm_fn": True},
}


def get_algorithm_spec(name: str) -> AlgorithmSpec:
    if name not in _TABLE:
        raise NotImplementedError(f"Algorithm not found: {name}")
    return AlgorithmSpec(MODELS[name], **_TABLE[name])


def resolve_aux_weight(spec: AlgorithmSpec, train_params: Dict) -> float:
    if spec.aux_weight is None or spec.aux_weight == "__zero__":
        return 0.0
    if spec.aux_weight == "__one__":
        return 1.0
    return float(train_params[spec.aux_weight])
