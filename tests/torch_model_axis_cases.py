"""The cases of tests/test_torch_model_axis.py: one rank of a job of 2 ranks
(mesh ``data=1, model=2``) or 4 (``data=2, model=2``) on the CPU (the
``GNNRUL_*`` variables set by
``gnn_rul_tpu_torch.parallel._dist_worker.launch``)::

    python tests/torch_model_axis_cases.py OUTDIR

Rank 0 writes ``OUTDIR/cases.pt``. Each of :data:`METHODS` at its tiny
widths, with the tensor-parallel rule's width at :data:`TP_MIN_DIM`, takes
two steps (global batches of 3 and 1 rows, dropout on) and an evaluation:
each step's weights before it, global loss and gradient gathered whole,
every rank's local shapes of the split parameters and their Adam moments,
and every rank's replicated parameters and buffers after the steps (the
predictions of those not in ``torch_mesh_cases.FP64_HELD``). At 2 ranks
also: HAGCN's placement around a forward that raises, STNet's two steps
at bf16 and through ``ShardedTrainer``, STFA's gradient at the bank's
widths from the JAX package's weights (``OUTDIR/stfa.pt``, written by the
test before the job), and HAGCN through the Trainer with checkpoints: two epochs straight, and one epoch then a resume. The test
module imports :func:`run`, :func:`grads_at` and :func:`sharded_trainer`
for the single process, so this file imports torch and the port alone.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mesh_cases as mesh_cases  # noqa: E402
from gnn_rul_tpu_torch.models import MODELS  # noqa: E402
from gnn_rul_tpu_torch.nn.basic import step_key  # noqa: E402
from gnn_rul_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from gnn_rul_tpu_torch.parallel.graph_partition import (  # noqa: E402
    spmm_hook_kwargs)
from gnn_rul_tpu_torch.parallel.model_axis import (  # noqa: E402
    placement_of, whole_grads)
from gnn_rul_tpu_torch.train.algorithms import (  # noqa: E402
    get_algorithm_spec)
from gnn_rul_tpu_torch.train.engine import Engine  # noqa: E402

TP_MIN_DIM = 8                 # tests/test_model_axis.py's tp_min_dim
# Tiny widths that the rule splits at TP_MIN_DIM: HAGCN's three Bi-LSTMs
# (on the recurrence kernel) and its Linears, STNet's ChebNet filters
# (their last axis), MLPs and LSTMLayer (on the library's LSTM),
# HierCorrPool's convolutions and Linears under its node-sharded hook.
METHODS = {
    "HAGCN": dict(patch_size=10, num_patch=5, encoder_hidden_dim=4,
                  hidden_dim=8, output_dim=8),
    "STNet": dict(num_patch=20, patch_size=128, num_nodes=9, nperseg=16,
                  input_dim=9, Cheb_layers=[16, 8], lstm_hidden_dim=4,
                  autoencoder_hidden_dim=8),
    "HierCorrPool": dict(patch_size=25, num_patch=2, input_dim=8,
                         hidden_dim=8, embedding_dim=8, num_nodes=14,
                         encoder_conv_kernel=8, num_nodes_out=6),
}
TRAIN_PARAMS = mesh_cases.TRAIN_PARAMS
CKPT_METHOD = "HAGCN"


def dtype(method):
    return (torch.float64 if method in mesh_cases.FP64_HELD
            else torch.float32)


def batches(method):
    return [(x.to(dtype(method)), y.to(dtype(method)))
            for x, y in mesh_cases.batches(method)]


def engine(method, mesh=None, hparams=None, precision="fp32"):
    """The method's engine at ``hparams`` (its tiny widths by default),
    seed 0, dropout on; over ``mesh`` placed by the rule and, where the
    method has one and the model axis is above 1, with its hook."""
    torch.manual_seed(0)
    kwargs = dict(hparams or METHODS[method])
    if mesh is not None and get_algorithm_spec(method).supports_spmm_fn:
        kwargs.update(spmm_hook_kwargs(method, mesh))
    model = MODELS[method](**kwargs).to(dtype(method))
    return Engine(model, get_algorithm_spec(method), TRAIN_PARAMS, seed=0,
                  device="cpu", mesh=mesh, precision=precision)


def whole_state(model):
    """The model's state_dict, split parameters gathered whole."""
    placement = placement_of(model)
    sd = (model.state_dict() if placement is None
          else placement.whole_state_dict(model))
    return {k: v.detach().clone() for k, v in sd.items()}


def run(method, mesh=None, hparams=None, precision="fp32"):
    """Two steps (the global batches of ``torch_mesh_cases.BATCH_ROWS``,
    keys of epoch 1) and an evaluation of 5 rows: each step's whole
    weights before it, global loss and whole gradients; the weights after;
    the predictions; and this rank's placement (the local shapes of each
    split parameter and its two Adam moments, the replicated parameters,
    the engine's count)."""
    eng = engine(method, mesh, hparams, precision)
    out = {"before": [], "loss": [], "grads": []}
    for i, (x, y) in enumerate(batches(method)):
        out["before"].append(whole_state(eng.model))
        loss = eng.train_step(x, y, key=step_key(0, 1, i))
        if eng.data_group is not None:
            torch.distributed.all_reduce(loss, group=eng.data_group)
        out["loss"].append(float(loss))
        out["grads"].append(whole_grads(eng.model))
    out["after"] = whole_state(eng.model)
    # The engine evaluates in fp32 (the inputs cast): not FP64_HELD.
    out["preds"] = (None if dtype(method) == torch.float64 else eng.evaluate(
        mesh_cases.x_rows(mesh_cases.EVAL_ROWS, 30, method)))
    placement = placement_of(eng.model)
    axes = placement.axes if placement is not None else {}
    params = dict(eng.model.named_parameters())
    out["local"] = {name: tuple(tuple(t.shape) for t in (
        params[name], eng.optimizer.state[params[name]]["exp_avg"],
        eng.optimizer.state[params[name]]["exp_avg_sq"])) for name in axes}
    out["replicated"] = {k: p.detach().clone() for k, p in [
        *params.items(), *eng.model.named_buffers()] if k not in axes}
    out["count"] = eng.tp_sharded_param_count()
    return out


def grads_at(method, state, step, hparams=None, precision="fp32"):
    """The single process's loss and gradients of step ``step`` of
    :func:`run` at the whole weights ``state``."""
    eng = engine(method, hparams=hparams, precision=precision)
    eng.model.load_state_dict(state)
    x, y = batches(method)[step]
    loss = eng.train_step(x, y, key=step_key(0, 1, step))
    return float(loss), whole_grads(eng.model)


def stfa_gradient(mesh, path):
    """STFA at the bank's widths (the rule's own width: its LSTM's two
    weights split) from the weights at ``path``, dropout off: the loss and
    whole gradient of one batch of 4 rows."""
    from gnn_rul_tpu_torch.configs.hparams import model_hparams
    eng = engine("STFA", mesh, model_hparams("CMAPSS", "FD001", "STFA"))
    no_dropout(eng.model)
    eng.model.load_state_dict(placement_of(eng.model).local_state_dict(
        torch.load(path)))
    x, y = stfa_batch()
    eng.model.train()
    loss = eng._loss(eng.model(x), y)
    loss.backward()
    return float(loss), whole_grads(eng.model), eng.tp_sharded_param_count()


def stfa_batch():
    rng = np.random.default_rng(17)
    return (torch.from_numpy(rng.normal(size=(4, 14, 50)).astype(np.float32)),
            torch.from_numpy(rng.uniform(size=(4, 1)).astype(np.float32)))


def no_dropout(model):
    """Every dropout of ``model`` off (p = 0)."""
    for mod in model.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    return model


def sharded_trainer(mesh=None):
    """Two ``ShardedTrainer`` steps of STNet at its tiny widths on batches
    of 3 and 1 and an evaluation of 5 rows over ``mesh``; with no mesh, an
    Engine doing the same. The losses, the whole weights after, the
    predictions."""
    from gnn_rul_tpu_torch.parallel.dp import ShardedTrainer
    torch.manual_seed(0)
    model = MODELS["STNet"](**METHODS["STNet"])
    data = batches("STNet")
    x_eval = mesh_cases.x_rows(mesh_cases.EVAL_ROWS, 30, "STNet")
    if mesh is not None:
        st = ShardedTrainer(model, mesh, lr=1e-3, weight_decay=1e-4,
                            device="cpu")
        st.init(seed=0)
        losses = [st.step(x.numpy(), y.numpy()) for x, y in data]
        return losses, whole_state(model), st.evaluate(x_eval)
    from gnn_rul_tpu_torch.train.algorithms import AlgorithmSpec
    eng = Engine(model, AlgorithmSpec(type(model)),
                 {"batch_size": 3, "learning_rate": 1e-3,
                  "weight_decay": 1e-4}, seed=0, device="cpu")
    losses = [float(eng.train_step(x, y)) for x, y in data]
    return losses, whole_state(model), eng.evaluate(x_eval)


def forward_that_raises(mesh):
    """HAGCN's placement over ``mesh`` around a forward that raises:
    whether each split parameter's slot holds the shard again, the leaf
    that Adam steps."""
    eng = engine("HAGCN", mesh)
    placement = placement_of(eng.model)
    shards = {name: owner._parameters[key]
              for name, (owner, key) in placement.owners.items()}

    def boom():
        raise RuntimeError("the forward failed")
    try:
        placement.forward(boom)
    except RuntimeError:
        pass
    stepped = {id(p) for g in eng.optimizer.param_groups for p in g["params"]}
    return all(owner._parameters[key] is shards[name]
               and id(shards[name]) in stepped
               for name, (owner, key) in placement.owners.items())


def trainer_runs(mesh, outdir):
    """HAGCN at its tiny widths through the Trainer on ``mesh``: two epochs
    straight, and one epoch with a checkpoint then a resume to two; each
    run's ``checkpoint.pt`` path (rank 0 writes them)."""
    from gnn_rul_tpu_torch.parallel._dist_worker import make_bundle
    from gnn_rul_tpu_torch.train.trainer import Trainer
    paths = {}
    for name, epochs, resume in (("straight", 2, False), ("first", 1, False),
                                 ("resumed", 2, True)):
        run_dir = "straight" if name == "straight" else "resumed"
        trainer = Trainer(
            CKPT_METHOD, "CMAPSS", "FD001", make_bundle(),
            save_dir=os.path.join(outdir, run_dir),
            experiment_description="tp", run_description="run", num_runs=1,
            mesh=mesh, device="cpu", checkpoint_every=1, resume=resume,
            model_hparams=METHODS[CKPT_METHOD],
            train_params={"num_epochs": epochs, "batch_size": 16,
                          "learning_rate": 1e-3, "weight_decay": 1e-4,
                          "alpha": 100})
        trainer.train()
        paths[name] = os.path.join(outdir, run_dir, "tp", "run",
                                   f"{CKPT_METHOD}_run_0", "checkpoint.pt")
    return paths


def main(outdir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    mesh_cases.lift_fp32_checks()
    k = int(os.environ["GNNRUL_NUM_PROCESSES"])
    mesh = mesh_lib.make_mesh(k // 2, 2, device="cpu")
    results = {}
    if k == 2:
        # At the rule's own width (256).
        results["STFA jax"] = stfa_gradient(mesh, os.path.join(outdir,
                                                               "stfa.pt"))
    mesh_lib.TP_MIN_DIM = TP_MIN_DIM
    for method in METHODS:
        results[method] = run(method, mesh)
    if k == 2:
        results["raised"] = forward_that_raises(mesh)
        results["bf16"] = run("STNet", mesh, precision="bf16")
        results["ShardedTrainer"] = sharded_trainer(mesh)
    # Every rank's view: the test holds each rank's placement and the
    # replicated parameters across the ranks.
    views = [None] * dist.get_world_size()
    dist.all_gather_object(views, {m: {"local": results[m]["local"],
                                       "replicated": results[m]["replicated"]}
                                   for m in METHODS})
    results["ranks"] = views
    if k == 2:
        results["checkpoints"] = trainer_runs(mesh, outdir)
    if dist.get_rank() == 0:
        torch.save(results, os.path.join(outdir, "cases.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
