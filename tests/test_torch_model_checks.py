"""Checks shared by the per-model port tests (tests/test_torch_hagcn.py,
test_torch_rgcnu.py, test_torch_gru_models.py, test_torch_hiercorrpool.py,
test_torch_dvgtformer.py, test_torch_tcn_models.py): a port model against the
JAX package's at CMAPSS/FD001 full width on the CPU, from the same
weights (carried by from_jax_variables) on the same seeded inputs. This
module holds no test of its own.

A forward that keeps the nodes of top score (HAGCN's SAGPool) is a step
function of its scores: where the k-th and (k+1)-th scores lie within
rounding, the two packages may keep other nodes. The port's forward
therefore replays the JAX package's choices, so that both compute one
function, and its own choices may differ from them only where the
swapped nodes' scores lie within the forward's relative tolerance of the
k-th. Where the port's 5-step trajectory misses the JAX package's (Adam's
normalised step on a gradient that cancels to rounding), both are held
against the JAX package's own steps in fp64 (``jax.enable_x64``) at the
same tolerance, and the port must be the closer of the two fp32 runs to
it: the rule chip_smoke.py holds each kernel to."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu.compat import import_torch_state_dict
from gnn_rul_tpu.configs import hparams
from gnn_rul_tpu.nn import basic as jax_basic
from gnn_rul_tpu.train import algorithms as jalgorithms
from gnn_rul_tpu.train import engine as jengine
from gnn_rul_tpu_torch import export
from gnn_rul_tpu_torch.compat import from_jax_variables
from gnn_rul_tpu_torch.configs.data_configs import get_dataset_config
from gnn_rul_tpu_torch.models import hagcn
from gnn_rul_tpu_torch.ops.kernels import WRAPPERS
from gnn_rul_tpu_torch.train import algorithms
from gnn_rul_tpu_torch.train.engine import Engine

torch.set_num_threads(1)

FWD_ATOL, FWD_RTOL = 2e-4, 1e-4        # tests/test_parity_fc_stgnn.py:69
# tests/test_parity_training.py:82-96
LOSS_RTOL, LOSS_ATOL, PARAM_MAX_DIFF = 2e-4, 2e-5, 5e-4
LIVE_ATOL, LIVE_RTOL = 1e-5, 1e-5      # tests/test_export.py:52
STEPS, STEP_ROWS = 5, 4
TRAIN_PARAMS = {"num_epochs": 1, "batch_size": STEP_ROWS,
                "learning_rate": 1e-3, "weight_decay": 1e-4, "alpha": 100,
                "lambda": 0.1}
# The methods whose forward keeps the nodes of top score, and the port
# module whose ``top_indices`` chooses them (jax.lax.top_k in the JAX
# package).
SELECTING = {"HAGCN": hagcn}


def hp(method):
    return hparams.model_hparams("CMAPSS", "FD001", method)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_model(method):
    return jalgorithms.get_algorithm_spec(method).model_cls(**hp(method))


def jax_variables(method, seed=0):
    """The JAX model's own initialisation from ``seed``, as numpy."""
    return numpy_tree(dict(jax_model(method).init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((2, 14, 50), jnp.float32), train=False)))


def x_rows(rows, seed):
    return np.random.default_rng(seed).normal(size=(rows, 14, 50)).astype(
        np.float32)


def no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def port_model(method, variables):
    model = export.build_model(method, "CMAPSS", "FD001")
    model.load_state_dict(from_jax_variables(method, variables), strict=True)
    return model


def hold(what, got, want, exact, atol, rtol):
    """``got`` (the port, fp32) against ``want`` (JAX, fp32) at ``atol +
    rtol * |want|``; where it misses, both against ``exact()`` (the JAX
    package in fp64): the port within the same tolerance of it, and closer
    to it than ``want``. Returns the reference that held."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if np.all(np.abs(got - want) <= atol + rtol * np.abs(want)):
        return "jax"
    e = np.asarray(exact(), np.float64)
    port_err, jax_err = np.abs(got - e).max(), np.abs(want - e).max()
    assert np.all(np.abs(got - e) <= atol + rtol * np.abs(e)), (
        f"{what}: the port misses JAX and JAX in fp64 by {port_err}")
    assert port_err < jax_err, (
        f"{what}: the port misses JAX; off JAX in fp64 by {port_err}, "
        f"JAX's fp32 by {jax_err}")
    return "jax_fp64"


def launches():
    return [(w.launches, getattr(w, "bwd_launches", 0))
            for w in WRAPPERS.values()]


def _recording(selections):
    """``jax.lax.top_k`` that appends each call's ``(k, indices)`` to
    ``selections``."""
    top_k = jax.lax.top_k

    def recorded(operand, k, **kwargs):
        values, indices = top_k(operand, k, **kwargs)
        selections.append((k, np.asarray(indices)))
        return values, indices
    return recorded


def _replaying(choose, selections, own):
    """A ``top_indices`` that returns the recorded ``selections`` in order
    and appends ``(scores, k, its own choice, the replayed one)`` to
    ``own``."""
    replay = iter(selections)

    def top_indices(scores, k):
        k_jax, chosen = next(replay)
        assert k_jax == k and chosen.shape == (*scores.shape[:-1], k)
        own.append((scores.detach().double().numpy(), k,
                    choose(scores, k).numpy(), chosen))
        return torch.from_numpy(chosen.astype(np.int64))
    return top_indices


def swapped(own, rtol):
    """The graphs whose kept nodes differ between the port's own choice and
    the replayed one. Fails where a node kept by one and not by the other
    scores, on the port, further than ``rtol`` of its graph's k-th score."""
    differ = 0
    for scores, k, mine, theirs in own:
        scores = scores.reshape(-1, scores.shape[-1])
        kept = []
        for chosen in (mine, theirs):
            m = np.zeros(scores.shape, bool)
            np.put_along_axis(m, chosen.reshape(-1, k), True, axis=-1)
            kept.append(m)
        sym = kept[0] ^ kept[1]
        differ += int(sym.any(-1).sum())
        kth = -np.sort(-scores, axis=-1)[:, k - 1:k]
        far = sym & (np.abs(scores - kth) > rtol * np.abs(kth))
        assert not far.any(), (
            f"nodes swapped between the choices score {scores[far]}, the "
            f"k-th {np.broadcast_to(kth, scores.shape)[far]}")
    return differ


def check_eval_forward(method, variables, rows, seed):
    """The eval forward against the JAX model's at FWD tolerance, on the
    plain versions (CPU tensors launch no kernel). A method in SELECTING
    replays the JAX forward's top-k choices; returns how many of the
    port's own choices differ from them (:func:`swapped`), 0 for any other
    method."""
    x = x_rows(rows, seed)
    selections, own = [], []
    module = SELECTING.get(method)
    with pytest.MonkeyPatch.context() as mp:
        if module:
            mp.setattr(jax.lax, "top_k", _recording(selections))
        want = np.asarray(jax_model(method).apply(
            variables, jnp.asarray(x), train=False))
        if module:
            mp.setattr(module, "top_indices",
                       _replaying(module.top_indices, selections, own))
        before = launches()
        with torch.no_grad():
            got = port_model(method, variables).eval()(
                torch.from_numpy(x)).numpy()
    assert launches() == before
    assert len(own) == len(selections)
    assert got.shape == want.shape == (rows, 1)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=FWD_RTOL)
    return swapped(own, FWD_RTOL)


def check_cell_forward(method, dataset, dataset_id, rows, seed):
    """The eval forward at another cell of the hparam bank (its widths, its
    dataset's sensors) against the JAX model's at FWD tolerance, from the
    JAX model's own initialisation at that cell. Returns the port's
    answers."""
    kwargs = hparams.model_hparams(dataset, dataset_id, method)
    jmodel = jalgorithms.get_algorithm_spec(method).model_cls(**kwargs)
    channels = get_dataset_config(dataset).input_channels
    variables = numpy_tree(dict(jmodel.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((2, channels, 50), jnp.float32), train=False)))
    x = np.random.default_rng(seed).normal(
        size=(rows, channels, 50)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    model = export.build_model(method, dataset, dataset_id)
    model.load_state_dict(from_jax_variables(method, variables), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (rows, 1)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=FWD_RTOL)
    return got


def check_round_trip(method, variables):
    """JAX -> port -> JAX gives back every leaf bit for bit, and the port
    model's keys are exactly those from_jax_variables writes."""
    model = port_model(method, variables)
    assert set(model.state_dict()) == set(from_jax_variables(method,
                                                             variables))
    back = import_torch_state_dict(method, model.state_dict(), hp(method))
    want_leaves, want_tree = jax.tree_util.tree_flatten_with_path(variables)
    got_leaves, got_tree = jax.tree_util.tree_flatten_with_path(
        numpy_tree(back))
    assert got_tree == want_tree
    for (path, want), (_, got) in zip(want_leaves, got_leaves):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))


def step_trajectories(method, monkeypatch):
    """STEPS Adam steps of each engine from the JAX engine's initial
    weights and BatchNorm statistics, each on its own seeded batch of
    STEP_ROWS (an epoch of one batch, shuffle off), with dropout off on both
    sides (the JAX package's Dropout patched to the identity). Returns (JAX
    losses, port losses, initial params, JAX params after, port engine, the
    batches, JAX batch_stats after)."""
    monkeypatch.setattr(jax_basic.Dropout, "__call__",
                        lambda self, x, train=False: x)
    rng = np.random.default_rng(7)
    batches = [(x_rows(STEP_ROWS, 100 + s),
                rng.uniform(size=(STEP_ROWS, 1)).astype(np.float32))
               for s in range(STEPS)]
    jax_engine = jengine.Engine(jax_model(method),
                                jalgorithms.get_algorithm_spec(method),
                                TRAIN_PARAMS, seed=0)
    state = jax_engine.init_state(batches[0][0])
    start = numpy_tree(state.params)
    port = Engine(no_dropout(port_model(method, {
        "params": start, "batch_stats": numpy_tree(state.batch_stats)})),
                  algorithms.get_algorithm_spec(method), TRAIN_PARAMS,
                  seed=0, device="cpu")
    jax_losses, port_losses = [], []
    for step, (x, y) in enumerate(batches, start=1):
        state, loss = jax_engine.run_epoch(state, x, y, step, shuffle=False)
        jax_losses.append(loss)
        port_losses.append(port.run_epoch(x, y, step, shuffle=False))
    return (np.array(jax_losses), np.array(port_losses), start,
            numpy_tree(state.params), port, batches,
            numpy_tree(state.batch_stats))


def _params(method, model, collection="params"):
    """A port model's parameters (or BatchNorm statistics) as the JAX
    tree's leaves, in fp64."""
    sd = {k: v.double() for k, v in model.state_dict().items()}
    return {path: np.asarray(leaf, np.float64) for path, leaf in
            jax.tree_util.tree_leaves_with_path(numpy_tree(
                import_torch_state_dict(method, sd, hp(method))[collection]))}


def check_running_statistics(method, port, jax_stats, smallest_rows):
    """The port's BatchNorm statistics after the steps against the JAX
    package's: running means at the JAX parity tests' tolerance; running
    variances within the bound of the biased/unbiased variance gap
    (ROADMAP.md Queue 3 entry 1; tests/test_torch_training.py states the
    bound, running_var / (n - 1) for the fewest rows ``smallest_rows`` a
    BN layer normalizes, however often a step updates it), never smaller
    than the JAX package's. Returns the number of statistics held."""
    got = _params(method, port.model, "batch_stats")
    want = jax.tree_util.tree_leaves_with_path(jax_stats)
    assert len(got) == len(want) > 0
    for path, leaf in want:
        if path[-1].key == "mean":
            np.testing.assert_allclose(got[path], leaf, atol=5e-4,
                                       rtol=1e-3, err_msg=str(path))
        else:
            np.testing.assert_allclose(
                got[path], leaf, atol=5e-4,
                rtol=1e-3 + 1.0 / (smallest_rows - 1), err_msg=str(path))
            assert np.all(got[path] >= leaf - 5e-4), path
    return len(want)


def _jax_fp64_trajectory(method, start, batches):
    """The JAX engine's STEPS steps in fp64 (``jax.enable_x64``) from
    ``start`` on the same batches: (losses, params as the tree's
    leaves)."""
    with jax.enable_x64(True):
        engine = jengine.Engine(jax_model(method),
                                jalgorithms.get_algorithm_spec(method),
                                TRAIN_PARAMS, seed=0)
        state = engine.init_state(batches[0][0].astype(np.float64))
        params, stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            (start, state.batch_stats))
        state = jengine.TrainState(params, stats, engine.tx.init(params),
                                   state.step)
        losses = []
        for step, (x, y) in enumerate(batches, start=1):
            state, loss = engine.run_epoch(state, x.astype(np.float64),
                                           y.astype(np.float64), step,
                                           shuffle=False)
            losses.append(loss)
        leaves = jax.tree_util.tree_leaves_with_path(
            numpy_tree(state.params))
    assert all(leaf.dtype == np.float64 for _, leaf in leaves)
    return np.array(losses), dict(leaves)


def check_trajectory(method, monkeypatch, unused=(), bn_rows=None):
    """The losses of STEPS steps at LOSS tolerance and every parameter
    within PARAM_MAX_DIFF after them, each by :func:`hold`; the steps moved
    the weights. ``unused`` names the top-level flax modules outside the
    loss: torch's Adam skips a parameter without a gradient, so the port
    (as the torch reference) leaves them as they were, while the JAX
    package's optimizer moves them by the weight decay; they are held to
    their start instead. A model with BatchNorm gives ``bn_rows``, the
    fewest rows any of its BN layers normalizes at STEP_ROWS, and its
    running statistics are held by :func:`check_running_statistics`.
    Returns the references that held (losses, parameters) and the JAX
    parameters' largest move in ``unused``."""
    jax_losses, port_losses, start, params, port, batches, jax_stats = \
        step_trajectories(method, monkeypatch)
    if bn_rows is None:
        assert not jax_stats
    else:
        check_running_statistics(method, port, jax_stats, bn_rows)
    assert np.isfinite(port_losses).all()
    exact = functools.cache(
        lambda: _jax_fp64_trajectory(method, start, batches))
    loss_ref = hold(f"{method} losses", port_losses, jax_losses,
                    lambda: exact()[0], LOSS_ATOL, LOSS_RTOL)
    got = _params(method, port.model)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    first = dict(jax.tree_util.tree_leaves_with_path(start))
    assert set(got) == set(want)
    frozen = {p for p in got if p[0].key in unused}
    assert len(frozen) == 2 * len(unused)  # a kernel and a bias each
    for p in frozen:
        np.testing.assert_array_equal(got[p], first[p], err_msg=str(p))
    jax_moved = max((float(np.max(np.abs(want[p] - first[p])))
                     for p in frozen), default=0.0)
    live = [p for p in got if p not in frozen]
    worst = max(float(np.max(np.abs(got[p] - want[p]))) for p in live)
    param_ref = "jax"
    if not worst < PARAM_MAX_DIFF:
        e = exact()[1]
        port_err = max(float(np.max(np.abs(got[p] - e[p]))) for p in live)
        jax_err = max(float(np.max(np.abs(want[p] - e[p]))) for p in live)
        assert port_err < PARAM_MAX_DIFF, (
            f"parameters diverge from JAX by {worst}, from JAX in fp64 by "
            f"{port_err}")
        assert port_err < jax_err, (
            f"parameters diverge from JAX by {worst}; off JAX in fp64 by "
            f"{port_err}, JAX's fp32 by {jax_err}")
        param_ref = "jax_fp64"
    assert max(float(np.max(np.abs(got[p] - first[p]))) for p in live) > 1e-4
    return loss_ref, param_ref, jax_moved


def check_symbolic_artifact(method, variables, tmp_path, rows=(1, 37)):
    """A symbolic-batch artifact exported, saved and loaded on the CPU
    answers as the live model does at LIVE tolerance, at every batch."""
    sd = from_jax_variables(method, variables)
    meta, program = export.export_serving(method, "CMAPSS", "FD001", sd,
                                          device="cpu")
    assert meta["input_shape"] == [None, 14, 50]
    path = export.save_artifact(str(tmp_path / f"{method}.pt2"), meta,
                                program)
    art = export.load_artifact(path, device="cpu")
    live = export.serving_model(method, "CMAPSS", "FD001", sd, device="cpu")
    for n in rows:
        x = x_rows(n, seed=n + 50)
        got = art(x)
        assert got.shape == (n,) and got.dtype == np.float32
        np.testing.assert_allclose(got, live(x), atol=LIVE_ATOL,
                                   rtol=LIVE_RTOL)
    return program


def op_nodes(program, op):
    target = getattr(torch.ops.gnn_rul_tpu_torch, op).default
    return sum(n.op == "call_function" and n.target is target
               for n in program.graph.nodes)


def our_op_nodes(program):
    """Calls of any of the port's registered operators in a program."""
    return sum(op_nodes(program, op) for op in WRAPPERS)
