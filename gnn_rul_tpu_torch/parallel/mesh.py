"""The (data, model) device mesh on ``torch.distributed`` (counterpart of
``gnn_rul_tpu/parallel/mesh.py``).

  - ``data``: each batch's rows split over the ranks in contiguous blocks
    (``parallel/data_axis.py``), the gradients summed over them;
  - ``model``: the wide parameters split over the ranks along their
    output axis (tensor parallelism, :func:`param_sharding_rule`,
    ``parallel/model_axis.py``), and the dense ``(N, N)`` graph algebra of
    the hooked methods split by node rows (``parallel/graph_partition.py``).

The mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
job's ranks, ``mesh_dim_names=("data", "model")``, rank ``d * M + m`` at
coordinate ``(d, m)``. A process outside a ``GNNRUL_*`` job
(``parallel/multihost.py``) forms a world of one, in memory.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..nn.recurrent import LSTMParams
from .model_axis import place
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


def param_sharding_rule(mesh: DeviceMesh) -> Callable[..., List]:
    """The tensor-parallel rule of the JAX package, as a pure function of a
    parameter and its output axis: that axis split over ``model`` where it
    is at least ``TP_MIN_DIM`` and divisible by the model axis, every
    parameter of fewer than two axes replicated. The output axis is the
    torch axis that holds the JAX layout's last one (:func:`output_axes`;
    the first of a Linear's ``(out, in)``, the last of ChebNet's
    ``filters (K, in, out)``)."""
    n_model = axis_size(mesh, "model")

    def rule(param: torch.Tensor, axis: int = 0) -> List:
        if _splits(param, axis, n_model):
            return [Replicate(), Shard(axis % param.dim())]
        return replicated(mesh)

    return rule


def _splits(param: torch.Tensor, axis: int, n_model: int) -> bool:
    return (param.dim() >= 2 and n_model > 1
            and param.shape[axis] >= TP_MIN_DIM
            and param.shape[axis] % n_model == 0)


# The modules whose weights keep torch's layout, output features first: a
# Linear's (out, in), a convolution's (out, in, *k), an RNN's
# (gates * H, in). The port keeps every other parameter of two or more
# axes in the JAX layout, output features last (ChebNet's filters (K, in,
# out), ST_Conv's theta, DVGTformer's t_v and x_v); the raw parameters
# that JAX stores transposed (GRU_CM's edge kernel, ASTGCNN's P) are
# Linears' weights in the port.
_OUTPUT_FIRST = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.LSTM, nn.GRU,
                 LSTMParams)


def output_axes(model: nn.Module) -> Dict[str, int]:
    """Each parameter of two or more axes of ``model``, by name, with its
    output axis: the torch axis that holds the JAX layout's last one."""
    return {f"{prefix}.{name}" if prefix else name:
            0 if isinstance(mod, _OUTPUT_FIRST) else p.dim() - 1
            for prefix, mod in model.named_modules()
            for name, p in mod.named_parameters(recurse=False)
            if p.dim() >= 2}


def sharded_params(model: nn.Module, n_model: int) -> List[str]:
    """The names of ``model``'s parameters that :func:`param_sharding_rule`
    splits over a model axis of ``n_model``."""
    params = dict(model.named_parameters())
    return [name for name, axis in output_axes(model).items()
            if _splits(params[name], axis, n_model)]


def shard_params(model: nn.Module, mesh: DeviceMesh):
    """Places ``model``'s parameters by :func:`param_sharding_rule`: each
    that it splits becomes this rank's block of it along its output axis,
    and the layers that use them compute from the blocks
    (``parallel/model_axis.py::place``). Returns the
    :class:`~.model_axis.Placement`, or None where the rule splits
    nothing."""
    names = sharded_params(model, axis_size(mesh, "model"))
    if not names:
        return None
    axes = output_axes(model)
    return place(model, {name: axes[name] for name in names},
                 mesh.get_group("model"))
