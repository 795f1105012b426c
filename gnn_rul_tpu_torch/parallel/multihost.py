"""Multi-process jobs on ``torch.distributed`` (counterpart of
``gnn_rul_tpu/parallel/multihost.py``).

A job of N processes, one rank each, is described to every process by
three environment variables, as the JAX package reads them:

    GNNRUL_COORDINATOR=host:port   rank 0's address (the TCP store)
    GNNRUL_NUM_PROCESSES=N         the world size
    GNNRUL_PROCESS_ID=r            this process's rank

and, where the ranks spread over several hosts, ``GNNRUL_LOCAL_PROCESSES``
(the ranks on each host; default N, one host). :func:`initialize_from_env`
joins the job with ``torch.distributed.init_process_group`` on
``tcp://host:port``, that world size and that rank.

The backend is fixed by one rule when the job starts, logged, and never
changed afterwards (:func:`backend_for`):

  - ``gloo`` for CPU tensors;
  - on the card, ``nccl`` where each rank on a host has a card of its own
    (the host's ranks at most its cards; rank r uses ``cuda:(r mod
    ranks a host)``), and ``gloo`` where ranks share a card (NCCL refuses
    two ranks on one device). Under gloo the collectives stage the card's
    tensors through host memory themselves (``parallel/data_axis.py``
    says which collectives the port uses).

Every rank keeps the whole training set in its device memory and indexes
its rows of each batch from it (FD001's 15,731 windows of 14 x 50 fp32 are
44 MB); the JAX package uploads 1/N of it to each process. The helpers
below place host arrays the way the JAX ones do, as plain tensors holding
this rank's part: :func:`shard_host_rows` its contiguous row block,
:func:`replicate_host_array` the whole array.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

ENV_COORDINATOR = "GNNRUL_COORDINATOR"
ENV_NUM_PROCESSES = "GNNRUL_NUM_PROCESSES"
ENV_PROCESS_ID = "GNNRUL_PROCESS_ID"
ENV_LOCAL_PROCESSES = "GNNRUL_LOCAL_PROCESSES"


def _job_from_env():
    """``(coordinator, world size, rank, ranks a host)`` of the job the
    environment describes, or None for a single process."""
    coord = os.environ.get(ENV_COORDINATOR)
    num = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    if not coord or num < 2:
        return None
    rank = int(os.environ[ENV_PROCESS_ID])
    local = int(os.environ.get(ENV_LOCAL_PROCESSES, str(num)))
    return coord, num, rank, local


def backend_for(device: str, ranks_per_host: int) -> str:
    """The backend rule: ``gloo`` on the CPU; on the card ``nccl`` where
    each of the host's ranks has a card of its own, ``gloo`` where they
    share one."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if ranks_per_host <= torch.cuda.device_count() else "gloo"


def initialize_from_env(device: str = "cuda") -> bool:
    """Join the job that the ``GNNRUL_*`` variables describe; returns True
    when this process is then one rank of several. Without the variables
    (or with N < 2) it returns False and touches nothing. ``device`` is the
    one the job trains on (``"cuda"`` or ``"cpu"``); on the card each rank
    makes ``cuda:(rank mod ranks a host, mod the host's cards)`` current.
    Call it before the first device query; a second call in an initialised
    process returns True."""
    job = _job_from_env()
    if job is None:
        return False
    if dist.is_initialized():
        return True
    coord, num, rank, local = job
    backend = backend_for(device, local)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device((rank % local) % torch.cuda.device_count())
    logging.getLogger(__name__).info(
        "rank %d of %d joins tcp://%s on %s (%d ranks a host, %s)", rank, num,
        coord, backend, local, device)
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=num, rank=rank)
    return True


def is_main_process() -> bool:
    """Rank 0 of the job, or a process outside any job: the one that
    writes artifacts."""
    return not dist.is_initialized() or dist.get_rank() == 0


def is_multiprocess_mesh(mesh) -> bool:
    """True when the mesh's ranks are more than this process."""
    return mesh is not None and mesh.mesh.numel() > 1


def process_row_slice(n_rows: int, mesh) -> slice:
    """The contiguous rows of a ``data``-sharded array of ``n_rows`` (a
    multiple of the data axis, :func:`padded_rows`) that this rank's data
    coordinate owns; ranks along ``model`` own the same rows."""
    n_data = mesh.size(0)
    if n_rows % n_data:
        raise ValueError(f"{n_rows} rows do not divide over the data axis "
                         f"of {n_data}")
    per = n_rows // n_data
    start = mesh.get_local_rank("data") * per
    return slice(start, start + per)


def padded_rows(n: int, mesh) -> int:
    """``n`` rounded up to a multiple of the data axis."""
    d = mesh.size(0)
    return -(-n // d) * d


def _device(mesh) -> torch.device:
    return torch.device(mesh.device_type)


def shard_host_rows(arr: np.ndarray, mesh) -> torch.Tensor:
    """This rank's contiguous row block of ``arr`` (an array every rank
    holds the same), on the mesh's device; the rows are padded first by
    repeating the last to a multiple of the data axis, as the JAX function
    pads them."""
    n = arr.shape[0]
    g = padded_rows(n, mesh)
    if g != n:
        arr = np.concatenate([arr, np.repeat(arr[-1:], g - n, axis=0)])
    block = np.ascontiguousarray(arr[process_row_slice(g, mesh)])
    return torch.as_tensor(block, device=_device(mesh))


def replicate_host_array(arr: np.ndarray, mesh) -> torch.Tensor:
    """The whole of ``arr`` (every rank holds the same) on the mesh's
    device."""
    return torch.as_tensor(np.asarray(arr), device=_device(mesh))


def put_global(arr, mesh, placements) -> torch.Tensor:
    """This rank's part of ``arr`` under ``placements`` (one
    ``torch.distributed.tensor`` placement a mesh dimension,
    ``parallel/mesh.py``): ``Shard(d)`` on a mesh dimension keeps this
    rank's contiguous block of axis d, ``Replicate()`` the whole. Every
    rank must hold the same ``arr``, as the JAX function requires."""
    t = torch.as_tensor(np.asarray(arr) if not isinstance(arr, torch.Tensor)
                        else arr, device=_device(mesh))
    for dim_name, placement in zip(mesh.mesh_dim_names, placements):
        if placement.is_shard():
            size = mesh.size(mesh.mesh_dim_names.index(dim_name))
            coord = mesh.get_local_rank(dim_name)
            t = torch.tensor_split(t, size, dim=placement.dim)[coord]
    return t.contiguous()

