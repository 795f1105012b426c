"""Checks shared by the per-model port tests (tests/test_torch_hagcn.py,
test_torch_rgcnu.py, test_torch_gru_models.py, test_torch_hiercorrpool.py,
test_torch_dvgtformer.py, test_torch_tcn_models.py,
test_torch_bearing_models.py, test_torch_gat_bearing.py,
test_torch_logo_bearing.py): a port model against the JAX package's at
full width on the CPU, CMAPSS/FD001 for an aero-engine method and
PHM2012/Condition_1 for a bearing method (:func:`cell`), from the same
weights (carried by from_jax_variables) on the same seeded inputs. This
module holds no test of its own.

SAGCN's and AGCN_TF's spectral features select a frequency bin (the
median and the peak of the spectrum), a step function of the FFT's
magnitudes whose mirror pairs ``|X[k]| = |X[n - k]|`` tie in exact math:
torch's FFT ties them exactly, the JAX package's complex FFT parts them by
rounding. The port replays the JAX package's bins, recorded inside its own
computation (:func:`record_bins`, :func:`replay`), and its own may differ
from them only where the two bins' power lies within the forward's
relative tolerance. STNet joins the nodes whose
score is above 0.7, and GDAGDL those whose importance is above 0, step
functions too: the port replays the JAX package's node masks, from its
scores recorded inside its jitted steps (:func:`record_scores`,
:func:`record_importance`), and its own may differ from them only where
the threshold lies between the two packages' scores.

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
it: the rule chip_smoke.py holds each kernel to. Where the JAX package's
own fp32 run misses its fp64 run too (GAT_LSTM's), a test may ask for
the gradient at each step's weights, port against JAX, to be held in the
parameters' place (:func:`check_step_gradients`), as chip_smoke.py's
GRADIENT_HELD does card against CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu.compat import import_torch_state_dict
from gnn_rul_tpu.models import gdagdl as jax_gdagdl
from gnn_rul_tpu.models import stnet as jax_stnet
from gnn_rul_tpu.configs import hparams
from gnn_rul_tpu.nn import basic as jax_basic
from gnn_rul_tpu.signal import features as jax_features
from gnn_rul_tpu.train import algorithms as jalgorithms
from gnn_rul_tpu.train import engine as jengine
from gnn_rul_tpu_torch import export
from gnn_rul_tpu_torch.compat import from_jax_variables
from gnn_rul_tpu_torch.configs.data_configs import get_dataset_config
from gnn_rul_tpu_torch.models import gdagdl, hagcn, stnet
from gnn_rul_tpu_torch.ops.kernels import WRAPPERS
from gnn_rul_tpu_torch.signal import features
from gnn_rul_tpu_torch.train import algorithms
from gnn_rul_tpu_torch.train.engine import Engine

torch.set_num_threads(1)

FWD_ATOL, FWD_RTOL = 2e-4, 1e-4        # tests/test_parity_fc_stgnn.py:69
# tests/test_parity_training.py:82-96
LOSS_RTOL, LOSS_ATOL, PARAM_MAX_DIFF = 2e-4, 2e-5, 5e-4
LIVE_ATOL, LIVE_RTOL = 1e-5, 1e-5      # tests/test_export.py:52
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4      # chip_smoke.py's kernel TOL
STEPS, STEP_ROWS = 5, 4
TRAIN_PARAMS = {"num_epochs": 1, "batch_size": STEP_ROWS,
                "learning_rate": 1e-3, "weight_decay": 1e-4, "alpha": 100,
                "lambda": 0.1, "theta": 0.001}
# The bearing methods, checked at PHM2012/Condition_1, the six that reach
# no port kernel first; those whose front end is sagcn_features select
# frequency bins; those whose graph joins the nodes above a threshold, the
# port module that holds it (THRESHOLD, high_nodes).
BEARING = ("HierCorrPool_bearing", "ST_GCN", "SAGCN", "AGCN_TF", "STMSGCN",
           "STNet", "GAT_LSTM", "GDAGDL", "LOGO_bearing")
NO_KERNEL_BEARING = BEARING[:6]
BINNING = ("SAGCN", "AGCN_TF")
THRESHOLDED = {"STNet": stnet, "GDAGDL": gdagdl}


def cell(method):
    """(dataset, dataset_id) of ``method``'s checks."""
    return (("PHM2012", "Condition_1") if method in BEARING
            else ("CMAPSS", "FD001"))


def input_shape(method):
    """(channels, length) of a window at ``method``'s cell."""
    cfg = get_dataset_config(cell(method)[0])
    return cfg.input_channels, cfg.sequence_len


def hp(method):
    return hparams.model_hparams(*cell(method), method)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_model(method):
    return jalgorithms.get_algorithm_spec(method).model_cls(**hp(method))


def jax_variables(method, seed=0):
    """The JAX model's own initialisation from ``seed``, as numpy."""
    return numpy_tree(dict(jax_model(method).init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((2, *input_shape(method)), jnp.float32), train=False)))


def x_rows(rows, seed, method=None):
    """Seeded windows: normal sensor readings at an aero-engine cell, a
    min-max scaled vibration signal (uniform in [0, 1)) at a bearing
    one."""
    rng = np.random.default_rng(seed)
    if method in BEARING:
        return rng.uniform(size=(rows, *input_shape(method))).astype(
            np.float32)
    return rng.normal(size=(rows, 14, 50)).astype(np.float32)


def _record(recorded, value):
    """Appends ``value`` to ``recorded`` as numpy when the JAX package
    computes it, inside jit too."""
    jax.debug.callback(lambda a: recorded.append(np.asarray(a).copy()),
                       value)


def record_top_k(mp):
    """Records the indices of every ``jax.lax.top_k`` call of an eager
    forward (HAGCN's SAGPool); returns ``{"top_indices": [...]}``, an
    array a call."""
    recorded = {"top_indices": []}
    top_k = jax.lax.top_k

    def recording(operand, k, **kwargs):
        values, indices = top_k(operand, k, **kwargs)
        recorded["top_indices"].append(np.asarray(indices))
        return values, indices
    mp.setattr(jax.lax, "top_k", recording)
    return recorded


class _BinRecordingJnp:
    """``jax.numpy`` for the JAX package's features module, whose
    ``argsort`` and ``argmax`` (the median's and the peak's selections)
    record the bins they choose. The bins are read from the very
    computation they steer: the JAX package's CPU FFT can round a mirror
    pair differently from one call to the next."""

    def __init__(self, recorded):
        self.recorded = recorded

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argsort(self, a, axis=-1, **kwargs):
        order = jnp.argsort(a, axis=axis, **kwargs)
        _record(self.recorded["median_bin"], order[:, a.shape[-1] // 2])
        return order

    def argmax(self, a, axis=None, **kwargs):
        chosen = jnp.argmax(a, axis=axis, **kwargs)
        _record(self.recorded["peak_bin"], chosen)
        return chosen


def record_bins(mp):
    """Records the median and peak bins of every ``frequency_features_8``
    call; returns ``{"median_bin": [...], "peak_bin": [...]}``."""
    recorded = {"median_bin": [], "peak_bin": []}
    mp.setattr(jax_features, "jnp", _BinRecordingJnp(recorded))
    return recorded


def record_scores(mp):
    """Records each JAX STNet forward's node scores (its ``cnn``'s output,
    ``(B, T, N)``); returns ``{"high_nodes": [...]}``."""
    recorded = {"high_nodes": []}
    conv2d = jax_stnet.Conv2d

    def recording(*args, **kwargs):
        module = conv2d(*args, **kwargs)

        def call(x):
            out = module(x)
            _record(recorded["high_nodes"], out[:, 0])
            return out
        return call
    mp.setattr(jax_stnet, "Conv2d", recording)
    return recorded


class _ImportanceRecordingJnp:
    """``jax.numpy`` for the JAX package's GDAGDL module, whose ``einsum``
    of the node importance (``adj @ score``) records the importance it
    gives, the input of GDAGDL's ``importance > 0``."""

    def __init__(self, recorded):
        self.recorded = recorded

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, subscripts, *operands, **kwargs):
        out = jnp.einsum(subscripts, *operands, **kwargs)
        if subscripts == "...nm,...mo->...no":
            _record(self.recorded["high_nodes"], out[..., 0])
        return out


def record_importance(mp):
    """Records each JAX GDAGDL forward's node importance (``(B*T, N)``);
    returns ``{"high_nodes": [...]}``."""
    recorded = {"high_nodes": []}
    mp.setattr(jax_gdagdl, "jnp", _ImportanceRecordingJnp(recorded))
    return recorded


def replayed_indices(theirs, x, *k):
    """A recorded top-k's or bin's indices as the port's selection."""
    assert theirs.shape == (*x.shape[:-1], *k)
    return torch.from_numpy(theirs.astype(np.int64))


def replayed_mask(theirs, scores, threshold):
    """The node mask of the JAX package's recorded scores."""
    assert theirs.shape == scores.shape
    return torch.from_numpy(
        (theirs > threshold).astype(np.float32)).to(scores.dtype)


def replay(mp, module, recorded, own, answer):
    """Patches each function of the port's ``module`` named in ``recorded``
    (as a ``record_*`` function returns it) to return ``answer(the JAX
    package's next recorded value, *args)``, read as each call runs (so
    lists that the JAX side fills step by step); appends ``(the call's
    input, the port's own choice, the recorded value)`` to ``own``."""
    for name, calls in recorded.items():
        choose, used = getattr(module, name), [0]

        def select(x, *args, choose=choose, calls=calls, used=used):
            jax.effects_barrier()
            theirs = calls[used[0]]
            used[0] += 1
            own.append((x.detach().double().numpy(),
                        choose(x, *args).numpy(), theirs))
            return answer(theirs, x, *args)
        mp.setattr(module, name, select)


def differing_bins(own, rtol):
    """The selections whose port bin differs from the replayed one. Fails
    where the two bins' values differ by more than ``rtol`` relative."""
    differ = 0
    for values, mine, theirs in own:
        rows = np.arange(len(mine))
        a, b = values[rows, mine], values[rows, theirs]
        differ += int((mine != theirs).sum())
        assert np.all(np.abs(a - b) <= rtol * np.abs(b)), (
            f"bins {mine[mine != theirs]} and {theirs[mine != theirs]} "
            f"differ in value")
    return differ


def no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def port_model(method, variables):
    model = export.build_model(method, *cell(method))
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


def swapped(own, rtol):
    """The graphs whose kept nodes differ between the port's own choice and
    the replayed one. Fails where a node kept by one and not by the other
    scores, on the port, further than ``rtol`` of its graph's k-th score."""
    differ = 0
    for scores, mine, theirs in own:
        k = theirs.shape[-1]
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


def differing_masks(method, threshold, own):
    """The node-mask entries where the port's own mask would differ from
    the JAX package's. Fails unless the threshold lies between the two
    scores at each (their rounding, or the steps' drift, parts them there,
    not a rule); prints the smallest margin and the scores' largest gap at
    a differing entry."""
    differ, margin, apart = 0, np.inf, 0.0
    for mine, _, theirs in own:
        theirs = theirs.astype(np.float64)
        margin = min(margin, float(np.abs(mine - threshold).min()))
        flipped = (mine > threshold) != (theirs > threshold)
        differ += int(flipped.sum())
        lo = np.minimum(mine, theirs)[flipped]
        hi = np.maximum(mine, theirs)[flipped]
        assert np.all((lo <= threshold) & (threshold <= hi))
        if flipped.any():
            apart = max(apart, float((hi - lo).max()))
    print(f"{method} node masks: {sum(m.size for m, _, _ in own)} entries, "
          f"smallest |score - {threshold}| {margin:.3e}; {differ} "
          f"differ from JAX's" + (f", their scores at most {apart:.3e} "
                                  f"apart" if differ else ""))
    return differ


# The methods whose forward takes a step function of its values, replayed
# from the JAX package into the port: (the port module whose functions
# take it, the JAX side's recorder, the port's answer of a recorded value,
# the count of the port's own choices that differ, failing where rounding
# does not explain them).
REPLAYED = {
    "HAGCN": (hagcn, record_top_k, replayed_indices,
              functools.partial(swapped, rtol=FWD_RTOL)),
    **{m: (features, record_bins, replayed_indices,
           functools.partial(differing_bins, rtol=FWD_RTOL))
       for m in BINNING},
    **{m: (module, {"STNet": record_scores,
                    "GDAGDL": record_importance}[m],
           functools.partial(replayed_mask, threshold=module.THRESHOLD),
           functools.partial(differing_masks, m, module.THRESHOLD))
       for m, module in THRESHOLDED.items()},
}


def check_eval_forward(method, variables, rows, seed):
    """The eval forward against the JAX model's at FWD tolerance, on the
    plain versions (CPU tensors launch no kernel). A method in REPLAYED
    replays the JAX forward's choices; returns how many of the port's own
    choices differ from them (0 for any other method)."""
    x = x_rows(rows, seed, method)
    own, recorded = [], {}
    module, record, answer, differing = REPLAYED.get(
        method, (None, None, None, lambda own: 0))
    with pytest.MonkeyPatch.context() as mp:
        if record:
            recorded = record(mp)
        want = np.asarray(jax_model(method).apply(
            variables, jnp.asarray(x), train=False))
        if record:
            replay(mp, module, recorded, own, answer)
        before = launches()
        with torch.no_grad():
            got = port_model(method, variables).eval()(
                torch.from_numpy(x)).numpy()
    assert launches() == before
    assert got.shape == want.shape == (rows, 1)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=FWD_RTOL)
    assert len(own) == sum(len(calls) for calls in recorded.values())
    return differing(own)


def check_cell_forward(method, dataset, dataset_id, rows, seed, length=50):
    """The eval forward at another cell of the hparam bank (its widths, its
    dataset's sensors, windows of ``length``) against the JAX model's at
    FWD tolerance, from the JAX model's own initialisation at that cell.
    Returns the port's answers."""
    kwargs = hparams.model_hparams(dataset, dataset_id, method)
    jmodel = jalgorithms.get_algorithm_spec(method).model_cls(**kwargs)
    channels = get_dataset_config(dataset).input_channels
    variables = numpy_tree(dict(jmodel.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((2, channels, length), jnp.float32), train=False)))
    rng = np.random.default_rng(seed)
    draw = rng.uniform if dataset in ("PHM2012", "XJTU_SY") else rng.normal
    x = draw(size=(rows, channels, length)).astype(np.float32)
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


def step_trajectories(method, monkeypatch, steps=STEPS, states=None):
    """``steps`` Adam steps of each engine from the JAX engine's initial
    weights and BatchNorm statistics, each on its own seeded batch of
    STEP_ROWS (an epoch of one batch, shuffle off), with dropout off on both
    sides (the JAX package's Dropout patched to the identity). With a list
    ``states``, appends the JAX engine's (params, batch_stats) before each
    step. Returns (JAX losses, port losses, initial params, JAX params
    after, port engine, the batches, JAX batch_stats after)."""
    monkeypatch.setattr(jax_basic.Dropout, "__call__",
                        lambda self, x, train=False: x)
    rng = np.random.default_rng(7)
    batches = [(x_rows(STEP_ROWS, 100 + s, method),
                rng.uniform(size=(STEP_ROWS, 1)).astype(np.float32))
               for s in range(steps)]
    jax_engine = jengine.Engine(jax_model(method),
                                jalgorithms.get_algorithm_spec(method),
                                TRAIN_PARAMS, seed=0)
    state = jax_engine.init_state(batches[0][0])
    start = numpy_tree(state.params)
    port = Engine(no_dropout(port_model(method, {
        "params": start, "batch_stats": numpy_tree(state.batch_stats)})),
                  algorithms.get_algorithm_spec(method), TRAIN_PARAMS,
                  seed=0, device="cpu")
    own = []
    if method in BINNING or method in THRESHOLDED:
        # Each JAX step records its choices before the port's step
        # replays them.
        module, record, answer, _ = REPLAYED[method]
        replay(monkeypatch, module, record(monkeypatch), own, answer)
    jax_losses, port_losses = [], []
    for step, (x, y) in enumerate(batches, start=1):
        if states is not None:
            states.append(numpy_tree((state.params, state.batch_stats)))
        state, loss = jax_engine.run_epoch(state, x, y, step, shuffle=False)
        jax_losses.append(loss)
        port_losses.append(port.run_epoch(x, y, step, shuffle=False))
    if method in THRESHOLDED:
        REPLAYED[method][3](own)
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
    """The JAX engine's steps in fp64 (``jax.enable_x64``) from
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


def _jax_gradient_fn(method):
    """``(params, batch_stats, x, y) -> the gradient`` of the JAX engine's
    training loss (its aux term at TRAIN_PARAMS' weight), jitted; dropout
    as the caller patched it before the first call."""
    spec = jalgorithms.get_algorithm_spec(method)
    weight = jalgorithms.resolve_aux_weight(spec, TRAIN_PARAMS)
    model = jax_model(method)

    def loss_fn(p, stats, x, y):
        out, _ = model.apply({"params": p, "batch_stats": stats}, x,
                             train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(0)})
        pred, aux = out if isinstance(out, tuple) else (out, None)
        loss = jnp.mean((pred - y) ** 2)
        return loss + weight * aux if aux is not None and weight else loss
    return jax.jit(jax.grad(loss_fn))


def _flat(tree):
    """(the leaves' paths, the leaves as one fp64 vector)."""
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    return ([path for path, _ in leaves],
            np.concatenate([np.asarray(leaf, np.float64).reshape(-1)
                            for _, leaf in leaves]))


def check_step_gradients(method, states, batches):
    """The gradient of the training loss, the port's against the JAX
    package's, at the JAX engine's weights before each step (``states``,
    as :func:`step_trajectories` records them) on that step's batch, by
    :func:`hold` at the kernels' tolerance (1e-5 + 1e-4 |g|, chip_smoke.py's
    TOL) with the JAX package's gradient in fp64 as the witness: both
    packages take one step from the same weights, whatever the weights'
    drift between the free-running runs. Dropout off on both sides, as the
    caller patched it."""
    spec = algorithms.get_algorithm_spec(method)
    gradient = _jax_gradient_fn(method)
    for i, ((params, stats), (x, y)) in enumerate(zip(states, batches)):
        model = no_dropout(port_model(method, {"params": params,
                                               "batch_stats": stats}))
        engine = Engine(model, spec, TRAIN_PARAMS, device="cpu")
        model.train()
        engine._loss(model(torch.from_numpy(x)), torch.from_numpy(y)) \
            .backward()
        sd = model.state_dict()
        sd.update({k: p.grad if p.grad is not None else torch.zeros_like(p)
                   for k, p in model.named_parameters()})
        paths, got = _flat(numpy_tree(import_torch_state_dict(
            method, sd, hp(method))["params"]))
        want_paths, want = _flat(numpy_tree(gradient(params, stats, x, y)))
        assert paths == want_paths

        def exact(params=params, stats=stats, x=x, y=y):
            with jax.enable_x64(True):
                to64 = functools.partial(jax.tree_util.tree_map,
                                         lambda a: np.asarray(a, np.float64))
                return _flat(numpy_tree(_jax_gradient_fn(method)(
                    to64(params), to64(stats), x.astype(np.float64),
                    y.astype(np.float64))))[1]
        hold(f"{method} step {i + 1}'s gradient", got, want, exact,
             GRAD_ATOL, GRAD_RTOL)


def check_trajectory(method, monkeypatch, unused=(), bn_rows=None,
                     steps=STEPS, gradient_held=False):
    """The losses of ``steps`` steps at LOSS tolerance and every parameter
    within PARAM_MAX_DIFF after them, each by :func:`hold`; the steps moved
    the weights. ``unused`` names the top-level flax modules outside the
    loss: torch's Adam skips a parameter without a gradient, so the port
    (as the torch reference) leaves them as they were, while the JAX
    package's optimizer moves them by the weight decay; they are held to
    their start instead. A model with BatchNorm gives ``bn_rows``, the
    fewest rows any of its BN layers normalizes at STEP_ROWS, and its
    running statistics are held by :func:`check_running_statistics`.
    With ``gradient_held``, parameters that miss JAX and JAX in fp64 are
    held instead by :func:`check_step_gradients` at every step, and only
    where the JAX package's own fp32 run misses its fp64 run by
    PARAM_MAX_DIFF too (chip_smoke.py's GRADIENT_HELD rule). Returns the
    references that held (losses, parameters: "jax", "jax_fp64" or
    "gradients") and the JAX parameters' largest move in ``unused``."""
    states = [] if gradient_held else None
    jax_losses, port_losses, start, params, port, batches, jax_stats = \
        step_trajectories(method, monkeypatch, steps, states)
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
        if gradient_held and not jax_err < PARAM_MAX_DIFF:
            print(f"{method}: parameters {worst} from JAX, {port_err} from "
                  f"JAX in fp64, JAX's fp32 {jax_err}: held by the gradient "
                  f"at each step")
            check_step_gradients(method, states, batches)
            return loss_ref, "gradients", jax_moved
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
    meta, program = export.export_serving(method, *cell(method), sd,
                                          device="cpu")
    assert meta["input_shape"] == [None, *input_shape(method)]
    path = export.save_artifact(str(tmp_path / f"{method}.pt2"), meta,
                                program)
    art = export.load_artifact(path, device="cpu")
    live = export.serving_model(method, *cell(method), sd, device="cpu")
    for n in rows:
        x = x_rows(n, seed=n + 50, method=method)
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
