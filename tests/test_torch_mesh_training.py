"""Training on the data axis of a mesh (``gnn_rul_tpu_torch/train/engine.py``
under ``parallel/data_axis.py``) on the CPU, against the single process.

One 2-rank gloo job (``tests/torch_mesh_cases.py``, run once for the
module) takes two steps of each of the 21 methods at the bank's widths,
dropout on and BatchNorm in train mode: a global batch of 3 (2 rows and 1
over the ranks), then one of 1 (1 row and a stand-in row), and an
evaluation of 5 rows. Each is held against the same steps in one process,
as tests/test_parallel.py holds the JAX engine's: the losses at the 5-step
tolerance (tests/test_parity_training.py:82-96), each step's gradients at
the kernels' tolerance against the single process's at the job's own
weights before the step, and the parameters after the steps within 5e-4
(but those whose gradient is rounding noise at every step, held by their
gradients: ROADMAP Queue 3 entry 19).
HAGCN, HierCorrPool and HierCorrPool_bearing run in fp64 on both sides
(torch_mesh_cases.FP64_HELD): in fp32 a ReLU, max-pool or top-k choice
within rounding of its kink goes either way between two summation orders,
and Adam's first steps then move a parameter by the learning rate whatever
its gradient. Also ShardedTrainer against the Engine, the row split, and
the refusals of a model axis."""

import os

import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
from gnn_rul_tpu_torch.export import build_model
from gnn_rul_tpu_torch.models import MODELS
from gnn_rul_tpu_torch.parallel import data_axis
from gnn_rul_tpu_torch.parallel._dist_worker import launch
from gnn_rul_tpu_torch.parallel.mesh import (param_sharding_rule,
                                             sharded_params, shard_params)
from gnn_rul_tpu_torch.train.trainer import check_model_axis

torch.set_num_threads(1)

LOSS_RTOL, LOSS_ATOL, PARAM_MAX_DIFF = 2e-4, 2e-5, 5e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
PRED_ATOL = 1e-4
JOB_TIMEOUT = 240


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_steps")
    launch([cases.__file__, str(out)], 2, JOB_TIMEOUT)
    return torch.load(os.path.join(out, "steps.pt"), weights_only=False)


def _hold_grads(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        excess = ((got[k] - want[k]).abs()
                  - (GRAD_ATOL + GRAD_RTOL * want[k].abs())).max().item()
        assert excess <= 0, (what, k, excess)


@pytest.mark.parametrize("method", list(MODELS))
def test_data_axis_steps_equal_the_single_process(job, method, monkeypatch):
    cases.lift_fp32_checks(monkeypatch.setattr)
    got, want = job[method], cases.run(method)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    for step, state in enumerate(got["before"]):
        _hold_grads(got["grads"][step], cases.grads_at(method, state, step),
                    f"{method} step {step}")
    # A parameter whose gradient is rounding noise at every step (a bias a
    # BatchNorm cancels: its true gradient is 0) moves by Adam's learning
    # rate whichever sign the noise takes: held by its gradients above.
    noise = {k for k in want["grads"][0]
             if all(g[k].abs().max() <= GRAD_ATOL for g in want["grads"])}
    diff = max((got["after"][k].double() - v.double()).abs().max().item()
               for k, v in want["after"].items()
               if v.is_floating_point() and k not in noise)
    assert diff < PARAM_MAX_DIFF, (method, diff)
    if want["preds"] is not None:
        np.testing.assert_allclose(got["preds"], want["preds"],
                                   atol=PRED_ATOL, rtol=0)


def test_sharded_trainer_equals_the_engine(job):
    (losses, state, preds), (w_losses, w_state, w_preds) = \
        job["ShardedTrainer"], cases.sharded_trainer()
    np.testing.assert_allclose(losses, w_losses, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    diff = max((state[k].double() - v.double()).abs().max().item()
               for k, v in w_state.items() if v.is_floating_point())
    assert diff < PARAM_MAX_DIFF
    np.testing.assert_allclose(preds, w_preds, atol=PRED_ATOL, rtol=0)


def test_placement_helpers_on_two_ranks(job):
    """parallel/multihost.py's helpers as each rank of the job saw them:
    rank 0 the main process, the rows of a 5-row array padded to 6 (the
    last repeated) and split 3 and 3, as the JAX helpers place them."""
    arr = torch.arange(10, dtype=torch.float32).reshape(5, 2)
    padded = torch.cat([arr, arr[-1:]])
    for rank, view in enumerate(job["placements"]):
        assert view["rank"] == rank and view["main"] == (rank == 0)
        assert view["multi"] and view["padded"] == 6
        assert view["slice"] == slice(3 * rank, 3 * rank + 3)
        assert torch.equal(view["rows"], padded[3 * rank:3 * rank + 3])
        assert torch.equal(view["whole"], arr)
        assert torch.equal(view["batch"], torch.tensor_split(arr, 2)[rank])
        assert torch.equal(view["replicated"], arr)


@pytest.mark.parametrize("total,size,blocks", [
    (31, 2, [(0, 16), (16, 15)]), (3, 2, [(0, 2), (2, 1)]),
    (1, 2, [(0, 1), (1, 0)]), (3, 4, [(0, 1), (1, 1), (2, 1), (3, 0)])])
def test_rows_split_in_contiguous_blocks(total, size, blocks):
    assert data_axis.split_rows(total, size) == blocks
    shards = [data_axis.RowShard(None, size, r, total, tuple(blocks))
              for r in range(size)]
    for shard, (start, count) in zip(shards, blocks):
        assert shard.rows == max(count, 1)
        assert shard.weight == float(count > 0)
        assert shard.local_index().tolist() == (
            list(range(start, start + count)) or [0])


class _Mesh:
    """A stand-in mesh of data=1 and model=``n``: the rule reads sizes
    alone."""
    mesh_dim_names = ("data", "model")

    def __init__(self, n):
        self.sizes = (1, n)

    def size(self, i):
        return self.sizes[i]


def test_param_sharding_rule_splits_wide_output_axes():
    rule = param_sharding_rule(_Mesh(2))
    assert rule(torch.zeros(512, 16))[1].is_shard()
    assert not rule(torch.zeros(16, 512))[1].is_shard()
    assert not rule(torch.zeros(512))[1].is_shard()
    assert not rule(torch.zeros(257, 3))[1].is_shard()
    assert not param_sharding_rule(_Mesh(1))(
        torch.zeros(512, 16))[1].is_shard()


@pytest.mark.parametrize("method,raises", [
    ("HAGCN", None), ("STAGNN", ValueError),
    ("FC_STGNN", None), ("STFA", None)])
def test_model_axis_refusals(method, raises):
    """A hookless method under model=2: JAX's ValueError where nothing is
    wide enough to shard (STAGNN); HAGCN passes, tensor parallelism
    splitting its second Bi-LSTM's four weights; a hooked method passes.
    ``shard_params`` places nothing under a model axis of 1."""
    model = build_model(method, "CMAPSS", "FD001")
    check_model_axis(method, model, 1)
    assert shard_params(model, _Mesh(1)) is None
    if raises is None:
        check_model_axis(method, model, 2)
    else:
        with pytest.raises(raises, match="no effect"):
            check_model_axis(method, model, 2)
    want = ([f"TD.bi_lstm2.weight_{w}_l0{sfx}" for sfx in ("", "_reverse")
             for w in ("ih", "hh")] if method == "HAGCN" else
            ["lstm.weight_ih_l0", "lstm.weight_hh_l0"] if method == "STFA"
            else [])
    assert sorted(sharded_params(model, 2)) == sorted(want)


@pytest.mark.parametrize("method", ["HAGCN", "STAGNN", "GDAGDL"])
def test_trainer_counts_and_checks_the_model_axis(method, tmp_path):
    """The trainer refuses a model axis of 2 for a hookless method with
    nothing wide enough to split (STAGNN) before it builds an engine (a
    stand-in mesh: the check reads sizes alone), as ``check_model_axis``
    does, and builds for one that splits (HAGCN, GDAGDL); its engine's
    ``tp_sharded_param_count`` counts what is placed, none at model=1."""
    import torch_mesh_cases as cases
    from gnn_rul_tpu_torch.data.loader import DataBundle
    from gnn_rul_tpu_torch.train.trainer import Trainer
    x = cases.x_rows(2, 0, method)
    data = DataBundle(x, np.zeros((2, 1), np.float32),
                      (x, np.zeros((2, 1), np.float32)), 125.0)
    model = build_model(method, *cases.cell(method))
    count = len(sharded_params(model, 2))
    if count:
        Trainer(method, *cases.cell(method), data, save_dir=str(tmp_path),
                mesh=_Mesh(2), device="cpu")
    else:
        with pytest.raises(ValueError, match="no effect"):
            Trainer(method, *cases.cell(method), data,
                    save_dir=str(tmp_path), mesh=_Mesh(2), device="cpu")
    trainer = Trainer(method, *cases.cell(method), data,
                      save_dir=str(tmp_path), mesh=_Mesh(1), device="cpu")
    assert trainer._build_engine(seed=0).tp_sharded_param_count() == 0


@pytest.mark.parametrize("start,rows", [(0, 2), (2, 3), (4, 1)])
def test_dropout_offset_draws_the_global_rows_mask(start, rows):
    """A rank's rows of a (5, 3, 4) batch draw the mask that one process
    draws on those rows: the kernel's plain version at the offset of the
    block's first element, and ``Dropout`` inside a RowShard."""
    from gnn_rul_tpu_torch.nn.basic import Dropout, dropout_key
    from gnn_rul_tpu_torch.ops.kernels import keyed_dropout as kd
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(5, 3, 4)).astype(np.float32))
    key = torch.tensor(11)
    full = kd.keyed_dropout_plain(x, key, 2, 0.3)
    part = kd.keyed_dropout_plain(x[start:start + rows].contiguous(), key, 2,
                                  0.3, offset=start * 12)
    assert torch.equal(part, full[start:start + rows])
    blocks = ((0, start), (start, rows), (start + rows, 5 - start - rows))
    shard = data_axis.RowShard(None, 3, 1, 5, blocks)
    drop = Dropout(0.3).train()
    with dropout_key(11):
        whole = drop(x)
    with dropout_key(11), data_axis.row_shard(shard):
        mine = drop(x[start:start + rows])
    assert torch.equal(mine, whole[start:start + rows])
