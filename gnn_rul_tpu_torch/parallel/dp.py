"""A training step over a (data, model) mesh (counterpart of
``gnn_rul_tpu/parallel/dp.py``).

:class:`ShardedTrainer` is the JAX class's interface on the port's
:class:`~..train.engine.Engine`: each batch given to :meth:`step` (the same
on every rank) is split over the ``data`` ranks, the loss is the global
batch's and the gradients are summed over the ranks; over a ``model`` axis
above 1 the parameters that the tensor-parallel rule splits are placed as
each rank's blocks of them (``parallel/mesh.py::shard_params``), Adam's
moments too. So the step equals the single process's (``train/engine.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..train.algorithms import AlgorithmSpec
from ..train.engine import Engine


class ShardedTrainer:
    """Train and eval steps of one model over a (data, model) mesh::

        mesh = make_mesh(n_data=2, n_model=2, device="cuda")
        st = ShardedTrainer(model, mesh, lr=1e-3, weight_decay=1e-4)
        st.init(seed=0)
        loss = st.step(x, y)          # the global batch, on every rank
        preds = st.evaluate(x_test)   # the whole vector, on every rank

    ``aux_weight`` weighs the auxiliary output of a model that returns
    ``(pred, aux)``. ``device`` defaults to the mesh's."""

    def __init__(self, model: nn.Module, mesh, lr: float,
                 weight_decay: float = 0.0, aux_weight: float = 0.0,
                 device: Optional[str] = None):
        self.model = model
        self.mesh = mesh
        self.lr, self.weight_decay = lr, weight_decay
        self.aux_weight = aux_weight
        self.device = device or mesh.device_type
        self.engine: Optional[Engine] = None

    def init(self, seed: int = 0) -> Engine:
        """The engine on the mesh, its optimizer fresh; ``seed`` keys its
        dropout (the model's weights are as constructed: build it after
        ``torch.manual_seed`` on every rank alike)."""
        spec = AlgorithmSpec(type(self.model),
                             aux_weight="__one__" if self.aux_weight else None)
        params = {"batch_size": 1, "learning_rate": self.lr,
                  "weight_decay": self.weight_decay}
        self.engine = Engine(self.model, spec, params, seed=seed,
                             device=self.device, mesh=self.mesh)
        self.engine.aux_weight = float(self.aux_weight)
        return self.engine

    def step(self, x, y) -> float:
        """One optimizer step on the global batch ``(x, y)``; returns the
        global batch's loss (the ranks' shares summed)."""
        if self.engine is None:
            self.init()
        dev = self.engine.device
        share = self.engine.train_step(torch.as_tensor(np.asarray(x),
                                                       device=dev),
                                       torch.as_tensor(np.asarray(y),
                                                       device=dev))
        if self.engine.data_group is not None:
            torch.distributed.all_reduce(share,
                                         group=self.engine.data_group)
        return float(share)

    def evaluate(self, x) -> np.ndarray:
        """Predictions for ``x`` in one eval batch split over the data
        ranks; the whole vector on every rank."""
        if self.engine is None:
            self.init()
        self.engine.eval_batch_size = len(x)
        return self.engine.evaluate(np.asarray(x))
