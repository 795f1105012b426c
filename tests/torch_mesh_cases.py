"""The cases of tests/test_torch_mesh_training.py that run on the data axis:
one rank of a 2-rank job on the CPU (the ``GNNRUL_*`` variables set by
``gnn_rul_tpu_torch.parallel._dist_worker.launch``)::

    python tests/torch_mesh_cases.py OUTDIR

Rank 0 writes ``OUTDIR/steps.pt``. The test module imports :func:`run` for
the single-process side, so this file imports torch and the port alone.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gnn_rul_tpu_torch.configs.hparams import model_hparams  # noqa: E402
from gnn_rul_tpu_torch.export import build_model  # noqa: E402
from gnn_rul_tpu_torch.models import MODELS  # noqa: E402
from gnn_rul_tpu_torch.nn.basic import step_key  # noqa: E402
from gnn_rul_tpu_torch.train.algorithms import (  # noqa: E402
    get_algorithm_spec)
from gnn_rul_tpu_torch.train.engine import Engine  # noqa: E402

BEARING = ("HierCorrPool_bearing", "ST_GCN", "SAGCN", "AGCN_TF", "STMSGCN",
           "STNet", "GAT_LSTM", "GDAGDL", "LOGO_bearing")
# tests/test_torch_model_checks.py's TRAIN_PARAMS.
TRAIN_PARAMS = {"num_epochs": 1, "batch_size": 4, "learning_rate": 1e-3,
                "weight_decay": 1e-4, "alpha": 100, "lambda": 0.1,
                "theta": 0.001}
# Held in fp64 on both sides, as tests/test_torch_vectorized.py holds
# HAGCN: in fp32 a ReLU or max-pool choice within rounding of its kink (and
# HAGCN's top-k, ROADMAP Queue 3 entry 6) can go either way between two
# summation orders, and its gradient with it; the kernels take fp32 alone,
# so their dtype checks are lifted and the plain versions run.
FP64_HELD = ("HAGCN", "HierCorrPool", "HierCorrPool_bearing")
# The global batches of the two steps: 3 rows (2 and 1 over two ranks),
# then 1 (1 and a stand-in row).
BATCH_ROWS = (3, 1)
EVAL_ROWS = 5


def cell(method):
    return (("PHM2012", "Condition_1") if method in BEARING
            else ("CMAPSS", "FD001"))


def x_rows(rows, seed, method):
    """Seeded windows at ``method``'s cell, as the model checks make
    them."""
    rng = np.random.default_rng(seed)
    if method in BEARING:
        return rng.uniform(size=(rows, 1, 2560)).astype(np.float32)
    return rng.normal(size=(rows, 14, 50)).astype(np.float32)


def _dtype(method):
    return torch.float64 if method in FP64_HELD else torch.float32


def lift_fp32_checks(setattr_=setattr):
    """Lets the kernels' plain versions take fp64 (FP64_HELD);
    ``setattr_`` a test's ``monkeypatch.setattr``."""
    from gnn_rul_tpu_torch.ops.kernels import fused_lstm, keyed_dropout
    setattr_(fused_lstm, "_check", lambda *a, **k: None)
    setattr_(keyed_dropout, "DTYPES", (*keyed_dropout.DTYPES, torch.float64))


def batches(method):
    return [(torch.from_numpy(x_rows(n, 10 + i, method)).to(_dtype(method)),
             torch.from_numpy(np.random.default_rng(20 + i).uniform(
                 size=(n, 1))).to(_dtype(method)))
            for i, n in enumerate(BATCH_ROWS)]


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def engine(method, mesh=None, **model_kwargs):
    """The method's engine at the bank's widths (and ``model_kwargs``, a
    hook), dropout on, seed 0."""
    torch.manual_seed(0)
    model = MODELS[method](**model_hparams(*cell(method), method),
                           **model_kwargs)
    return Engine(model.to(_dtype(method)), get_algorithm_spec(method),
                  TRAIN_PARAMS, seed=0, device="cpu", mesh=mesh)


def run(method, mesh=None, **model_kwargs):
    """Two steps (the global batches of :data:`BATCH_ROWS`, keys of epoch
    1) and an evaluation; returns each step's state before it, global loss
    and summed gradients, the state after, and the predictions."""
    eng = engine(method, mesh, **model_kwargs)
    out = {"before": [], "loss": [], "grads": []}
    for i, (x, y) in enumerate(batches(method)):
        out["before"].append(_state(eng.model))
        loss = eng.train_step(x, y, key=step_key(0, 1, i))
        if eng.data_group is not None:
            torch.distributed.all_reduce(loss, group=eng.data_group)
        out["loss"].append(float(loss))
        out["grads"].append({k: p.grad.detach().clone()
                             for k, p in eng.model.named_parameters()
                             if p.grad is not None})
    out["after"] = _state(eng.model)
    # The engine evaluates in fp32 (the inputs cast), so not FP64_HELD.
    out["preds"] = (None if method in FP64_HELD
                    else eng.evaluate(x_rows(EVAL_ROWS, 30, method)))
    return out


def grads_at(method, state, step):
    """The single process's gradients of step ``step`` of :func:`run` at
    the weights ``state``."""
    eng = engine(method)
    eng.model.load_state_dict(state)
    x, y = batches(method)[step]
    eng.train_step(x, y, key=step_key(0, 1, step))
    return {k: p.grad.detach().clone() for k, p in eng.model.named_parameters()
            if p.grad is not None}


def sharded_trainer(mesh=None):
    """Two steps of ``ShardedTrainer`` (FC_STGNN) on batches of 5 and 3 and
    an evaluation of 5 rows; with no mesh, an ``Engine`` doing the same."""
    from gnn_rul_tpu_torch.parallel.dp import ShardedTrainer
    torch.manual_seed(0)
    model = build_model("FC_STGNN", "CMAPSS", "FD001")
    xs = [x_rows(n, 40 + n, "FC_STGNN") for n in (5, 3)]
    ys = [np.random.default_rng(n).uniform(size=(n, 1)).astype(np.float32)
          for n in (5, 3)]
    if mesh is not None:
        st = ShardedTrainer(model, mesh, lr=1e-3, weight_decay=1e-4,
                            device="cpu")
        st.init(seed=0)
        losses = [st.step(x, y) for x, y in zip(xs, ys)]
        return losses, _state(model), st.evaluate(xs[0])
    eng = Engine(model, get_algorithm_spec("FC_STGNN"),
                 {"batch_size": 5, "learning_rate": 1e-3,
                  "weight_decay": 1e-4}, seed=0, device="cpu")
    losses = [float(eng.train_step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in zip(xs, ys)]
    return losses, _state(model), eng.evaluate(xs[0])


def placements(mesh):
    """Every rank's view of ``parallel/multihost.py``'s placement helpers
    on ``mesh`` (data=2): a 5-row array's row block (padded to 6), the
    whole array, and ``put_global`` under the batch and replicated
    placements."""
    import torch.distributed as dist
    from gnn_rul_tpu_torch.parallel import mesh as pm, multihost as mh
    arr = np.arange(10, dtype=np.float32).reshape(5, 2)
    mine = {"rank": dist.get_rank(), "main": mh.is_main_process(),
            "multi": mh.is_multiprocess_mesh(mesh),
            "padded": mh.padded_rows(5, mesh),
            "slice": mh.process_row_slice(6, mesh),
            "rows": mh.shard_host_rows(arr, mesh),
            "whole": mh.replicate_host_array(arr, mesh),
            "batch": mh.put_global(arr, mesh, pm.batch_sharding(mesh)),
            "replicated": mh.put_global(arr, mesh, pm.replicated(mesh))}
    views = [None] * dist.get_world_size()
    dist.all_gather_object(views, mine)
    return views


def main(outdir):
    import torch.distributed as dist
    from gnn_rul_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)
    lift_fp32_checks()
    mesh = make_mesh(2, 1, device="cpu")
    results = {m: run(m, mesh) for m in MODELS}
    results["ShardedTrainer"] = sharded_trainer(mesh)
    results["placements"] = placements(mesh)
    if dist.get_rank() == 0:
        torch.save(results, os.path.join(outdir, "steps.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
