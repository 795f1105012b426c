"""The (data, model) device mesh on ``torch.distributed`` (counterpart of
``gnn_rul_tpu/parallel/mesh.py``).

  - ``data``: each batch's rows split over the ranks in contiguous blocks
    (``parallel/data_axis.py``), the gradients summed over them;
  - ``model``: the dense ``(N, N)`` graph algebra of the hooked methods
    split by node rows over the ranks (``parallel/graph_partition.py``).

The mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
job's ranks, ``mesh_dim_names=("data", "model")``, rank ``d * M + m`` at
coordinate ``(d, m)``. A process outside a ``GNNRUL_*`` job
(``parallel/multihost.py``) forms a world of one, in memory.

Tensor-parallel parameter sharding, which the JAX package applies to the
kernels of the methods without a hook, is not ported (ROADMAP.md, Queue 1):
:func:`param_sharding_rule` says which parameters it would shard, and
:func:`shard_params` refuses a rule that shards any.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from .multihost import initialize_from_env


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over every rank of the job, ``n_data * n_model``
    of them (``n_data`` defaults to the world size over ``n_model``).
    Joins the ``GNNRUL_*`` job if this process has not yet, and forms a
    world of one where there is none. ``device`` is ``"cuda"`` or
    ``"cpu"``, the device the ranks train on."""
    device_type = torch.device(device).type
    if not dist.is_initialized() and not initialize_from_env(device):
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"a mesh of data={n_data} x model={n_model} needs "
                         f"{n_data * n_model} ranks; the job has {world}")
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The size of ``axis`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def batch_sharding(mesh: DeviceMesh) -> List:
    """The placements of a batch: its leading axis split over ``data``,
    replicated over ``model``."""
    return [Shard(0), Replicate()]


def replicated(mesh: DeviceMesh) -> List:
    """Every axis whole on every rank."""
    return [Replicate() for _ in mesh.mesh_dim_names]


# The narrowest output-feature axis that tensor parallelism splits (the JAX
# package's ``tp_min_dim``).
TP_MIN_DIM = 256


def param_sharding_rule(mesh: DeviceMesh) -> Callable[[torch.Tensor], List]:
    """The tensor-parallel rule of the JAX package, as a pure function of a
    parameter: its output-feature axis split over ``model`` where that axis
    is at least ``TP_MIN_DIM`` and divisible by the model axis, every
    parameter of fewer than two axes replicated. The output-feature axis is
    the first of a torch weight (``nn.Linear``'s ``(out, in)``,
    ``nn.Conv1d``'s ``(out, in, k)``, an RNN's ``(gates*H, in)``), the last
    of the JAX kernel."""
    n_model = axis_size(mesh, "model")

    def rule(param: torch.Tensor) -> List:
        if _splits(param, n_model):
            return [Replicate(), Shard(0)]
        return replicated(mesh)

    return rule


def _splits(param: torch.Tensor, n_model: int) -> bool:
    return (param.dim() >= 2 and n_model > 1
            and param.shape[0] >= TP_MIN_DIM
            and param.shape[0] % n_model == 0)


def sharded_params(model: nn.Module, n_model: int) -> List[str]:
    """The names of ``model``'s parameters that :func:`param_sharding_rule`
    would split over a model axis of ``n_model``."""
    return [name for name, p in model.named_parameters()
            if _splits(p, n_model)]


def shard_params(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Places ``model``'s parameters by :func:`param_sharding_rule`. Only
    the rule that replicates every parameter is ported: one that would
    shard any raises ``NotImplementedError`` (ROADMAP.md, Queue 1)."""
    names = sharded_params(model, axis_size(mesh, "model"))
    if names:
        raise NotImplementedError(
            f"tensor-parallel parameter sharding over the model axis is not "
            f"ported yet ({len(names)} parameters would be split, e.g. "
            f"{names[0]}); the port's order of work is in ROADMAP.md")
    return model
