"""Parameters split over the mesh's ``model`` axis (tensor parallelism):
the collectives' autograd rules, and the placement that stores each split
parameter as this rank's shard and gathers it for the forward. The JAX package has no such module: there XLA
inserts these collectives itself from the placements of
``gnn_rul_tpu/parallel/mesh.py::param_sharding_rule``.

A parameter that the rule splits (``parallel/mesh.py::sharded_params``) is
stored on model rank m of M as block m of M along its output axis, the
axis that the JAX layout's last one maps to, under its own key. Adam is
built on the shards, so a rank holds 1/M of the parameter and of its two
moments, and Adam's elementwise step on a shard is that block of the whole
step (weight decay too). Every model rank of a data block holds the same
rows and the same replicated parameters, so the model runs whole on each
of them and each computes the whole loss. The autograd rules follow
(``parallel/graph_partition.py``'s node-sharded engines use all three);
each is one ``all_reduce`` or one ``all_gather``, the two collectives gloo
takes on CUDA tensors:

  - :func:`copy_to_model`: the identity on a tensor every rank holds
    whole; its gradient, this rank's part of it, summed over the group;
  - :func:`gather_from_model`: the whole tensor from every rank's block
    along an axis; the whole tensor's gradient is the same on every rank,
    so each keeps its block, with no reduce (so a gathered weight's
    gradient is sliced back to the shard);
  - :func:`slice_to_model`: this rank's block of a tensor every rank holds
    whole; the gradient of each block gathered.

Every split parameter is gathered whole at the start of the model's
forward (:meth:`Placement.forward`), used whole by whatever reads it (a
layer's own call, cuDNN's LSTM, the recurrence kernel's ``W_hh``, a raw
parameter in an einsum), and its gradient is sliced back to the shard.
So no layer below knows of the split, and a rank's memory for it is 1/M
but for the whole tensors of one forward.

Replicated parameters get the same gradient on every model rank in exact
arithmetic, and a step averages it over the group
(:meth:`Placement.average_replicated`, one all-reduce), so that the order
of floating-point sums (atomics on the card) cannot part the ranks'
copies. The ``state_dict`` keeps its keys; a checkpoint holds whole
tensors (:meth:`Placement.whole_state_dict`,
:meth:`Placement.whole_optimizer_state`, which every rank of the group
calls), and a whole checkpoint is cut back to a rank's blocks on loading
(:meth:`Placement.local_state_dict`,
:meth:`Placement.local_optimizer_state`).
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .data_axis import all_gather_blocks


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SliceToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(t, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _whole(g, ctx.group, ctx.dim), None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _whole(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.dim).contiguous(), None, None


def copy_to_model(t: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(t, group)


def slice_to_model(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _SliceToModel.apply(t, group, dim)


def gather_from_model(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherFromModel.apply(t, group, dim)


def _block(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (not differentiable)."""
    return t.chunk(dist.get_world_size(group), dim)[dist.get_rank(group)]


def _whole(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The tensor of every rank's block ``t`` along ``dim`` (not
    differentiable)."""
    return torch.cat(all_gather_blocks(t.contiguous(), group), dim=dim)


def _refresh_rnn(mod: nn.Module) -> None:
    """An RNN's flat weights pointed at the tensors it holds now, without
    cuDNN's flattening (which would rewrite them in place)."""
    if isinstance(mod, nn.RNNBase):
        mod._flat_weights = [getattr(mod, n) for n in mod._flat_weights_names]
        mod._flat_weight_refs = [weakref.ref(w) for w in mod._flat_weights]


@dataclasses.dataclass
class Placement:
    """Where a model's parameters lie over the model group: ``axes`` maps
    each split parameter's name to its split axis, ``owners`` to the
    module that holds it and its name there."""
    group: Any
    axes: Dict[str, int]
    owners: Dict[str, Tuple[nn.Module, str]]

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    def _swap(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        old = {}
        for name, (owner, key) in self.owners.items():
            old[name] = owner._parameters[key]
            owner._parameters[key] = tensors[name]
            _refresh_rnn(owner)
        return old

    def forward(self, inner, *args, **kwargs):
        """``inner`` (the model's own forward) on the whole gathered
        weights; the shards are back in place after it, also where it
        raises."""
        whole = {name: gather_from_model(owner._parameters[key], self.group,
                                         self.axes[name])
                 for name, (owner, key) in self.owners.items()}
        shards = self._swap(whole)
        try:
            return inner(*args, **kwargs)
        finally:
            self._swap(shards)

    def average_replicated(self, model: nn.Module) -> None:
        """Each replicated parameter's gradient averaged over the model
        group, in one all-reduce of a flat buffer."""
        grads = [p.grad for name, p in model.named_parameters()
                 if name not in self.axes and p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat /= self.size
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def whole_state_dict(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """``model.state_dict()`` with every split parameter gathered whole
        (a collective: every rank of the group calls it)."""
        sd = model.state_dict()
        for name, axis in self.axes.items():
            sd[name] = _whole(sd[name].detach(), self.group, axis)
        return sd

    def local_state_dict(self, sd: Dict[str, Any]) -> Dict[str, Any]:
        """A whole ``state_dict`` with every split parameter cut to this
        rank's block."""
        sd = dict(sd)
        for name, axis in self.axes.items():
            sd[name] = _block(sd[name], self.group, axis).clone()
        return sd

    def _moments(self, model: nn.Module, osd: Dict[str, Any], fn):
        """``osd`` (an Adam ``state_dict`` over ``model.parameters()``)
        with ``fn(moment, axis)`` in the place of each split parameter's
        moments; the optimizer's own state is left as it is."""
        osd = dict(osd, state={i: dict(s) for i, s in osd["state"].items()})
        for i, (name, _) in enumerate(model.named_parameters()):
            if name in self.axes and i in osd["state"]:
                for key in ("exp_avg", "exp_avg_sq"):
                    osd["state"][i][key] = fn(osd["state"][i][key],
                                              self.axes[name])
        return osd

    def whole_optimizer_state(self, model: nn.Module,
                              optimizer: torch.optim.Optimizer
                              ) -> Dict[str, Any]:
        """``optimizer.state_dict()`` with each split parameter's moments
        gathered whole (a collective)."""
        return self._moments(model, optimizer.state_dict(),
                             lambda t, axis: _whole(t, self.group, axis))

    def local_optimizer_state(self, model: nn.Module,
                              osd: Dict[str, Any]) -> Dict[str, Any]:
        """A whole Adam ``state_dict`` with each split parameter's moments
        cut to this rank's block."""
        return self._moments(
            model, osd, lambda t, axis: _block(t, self.group, axis).clone())


def place(model: nn.Module, axes: Dict[str, int], group) -> Placement:
    """Splits the parameters of ``model`` named in ``axes`` (name -> axis)
    over ``group``: each is replaced by this rank's block of it, a new
    leaf, and the model's forward gathers them whole
    (:meth:`Placement.forward`). Returns the placement, which the model
    keeps (:func:`placement_of`). The model's replicated parameters must be
    the same on every rank (built from one seed)."""
    modules = dict(model.named_modules())
    owners: Dict[str, Tuple[nn.Module, str]] = {}
    for name, axis in axes.items():
        prefix, _, key = name.rpartition(".")
        owner = modules[prefix]
        old = owner._parameters[key]
        owner._parameters[key] = nn.Parameter(
            _block(old.detach(), group, axis).clone(),
            requires_grad=old.requires_grad)
        _refresh_rnn(owner)
        owners[name] = (owner, key)
    placement = Placement(group, dict(axes), owners)
    model.forward = functools.partial(placement.forward, model.forward)
    model.tp_placement = placement
    return placement


def placement_of(model: nn.Module):
    """The model's :class:`Placement`, or None where nothing is split."""
    return getattr(model, "tp_placement", None)


def whole_grads(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient (those that have one), the split ones
    gathered whole (a collective where the model is placed)."""
    placement = placement_of(model)
    axes = placement.axes if placement is not None else {}
    return {name: (_whole(p.grad, placement.group, axes[name])
                   if name in axes else p.grad).detach().clone()
            for name, p in model.named_parameters() if p.grad is not None}


def local_bytes(model: nn.Module, optimizer: torch.optim.Optimizer
                ) -> Dict[str, int]:
    """The bytes this rank holds of each split parameter and of its Adam
    moments, from the tensors' own sizes."""
    placement = placement_of(model)
    out = {}
    for name, p in model.named_parameters():
        if placement is None or name not in placement.axes:
            continue
        state = optimizer.state.get(p, {})
        out[name] = sum(t.numel() * t.element_size()
                        for t in (p, state.get("exp_avg"),
                                  state.get("exp_avg_sq"))
                        if t is not None)
    return out

