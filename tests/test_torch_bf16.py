"""``--precision bf16`` in the port (gnn_rul_tpu_torch) on the CPU, against
the JAX package: each kernel module's plain bf16 version against the JAX
Pallas kernel in interpret mode at bf16; FC_STGNN, LOGO and STAGNN's first
bf16 step (loss and gradient) and 5 bf16 steps against the JAX engine's
``precision="bf16"``; one bf16 train step and eval forward of every method
(mirrors tests/test_bf16.py); the bf16 serving model, the precision
guidance and BatchNorm's fp32 statistics.

Tolerances. The kernels compute in fp32 from bf16 operands and round each
output once, so two versions of one may part by the rounding of fp32
sums taken in other orders: 2 bf16 ulps (2^-6 |ref|) plus 2^-10. A
model's bf16 forward rounds at every op, and the two frameworks round at
other places (XLA's CPU bf16 products and jnp's einsum, the port's fp32
kernels): the first step's loss within 2%, its gradient within 10% of the
gradient's norm; the 5-step losses within the JAX package's own bf16
bound (tests/test_bf16.py:49)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from gnn_rul_tpu.compat import import_torch_state_dict
from gnn_rul_tpu.nn import basic as jax_basic
from gnn_rul_tpu.ops.pallas import fused_lstm as jax_lstm
from gnn_rul_tpu.ops.pallas.fused_gat import fused_gat_pallas
from gnn_rul_tpu.ops.pallas.fused_gnn import (
    fused_dot_graph_spmm_bwd_pallas, fused_dot_graph_spmm_packed,
    fused_dot_graph_spmm_pallas)
from gnn_rul_tpu.train import algorithms as jalgorithms
from gnn_rul_tpu.train import engine as jengine
from gnn_rul_tpu_torch import export
from gnn_rul_tpu_torch.export import build_model
from gnn_rul_tpu_torch.models import MODELS
from gnn_rul_tpu_torch.nn.basic import BatchNorm1d, BatchNormNCL
from gnn_rul_tpu_torch.ops.kernels import fused_gat, fused_gnn, fused_lstm
from gnn_rul_tpu_torch.train import precision
from gnn_rul_tpu_torch.train.algorithms import get_algorithm_spec
from gnn_rul_tpu_torch.train.engine import Engine
from test_torch_model_checks import (TRAIN_PARAMS, cell, hp, jax_model,
                                     no_dropout, numpy_tree, port_model,
                                     x_rows)

torch.set_num_threads(1)

BF = torch.bfloat16
KERNEL_RTOL, KERNEL_ATOL = 2.0 ** -6, 2.0 ** -10
FIRST_LOSS_RTOL, GRAD_NORM_RTOL = 0.02, 0.10
LOSS_RTOL, LOSS_ATOL = 0.15, 0.01          # tests/test_bf16.py:49


def _bf16(*arrays):
    """numpy arrays rounded to bf16: (torch tensors, jnp arrays)."""
    t = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF)
         for a in arrays]
    return t, [jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in t]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=KERNEL_RTOL,
                               atol=KERNEL_ATOL, err_msg=what)


# ------------------------------------------------------------------ kernels


@pytest.mark.parametrize("b,n,d,f", [(6, 28, 16, 16), (4, 5, 3, 7)])
@pytest.mark.parametrize("jax_fn", ["pallas", "packed"])
def test_dot_graph_plain_bf16_matches_pallas_interpret(b, n, d, f, jax_fn):
    rng = np.random.default_rng(n)
    (h, x, mask), (jh, jx, jm) = _bf16(
        rng.normal(size=(b, n, d)) * d ** -0.25, rng.normal(size=(b, n, f)),
        rng.uniform(size=(n, n)))
    fn = (fused_dot_graph_spmm_pallas if jax_fn == "pallas"
          else fused_dot_graph_spmm_packed)
    want = fn(jh, jx, jm, interpret=True)
    got = fused_gnn.fused_dot_graph_spmm_plain(h, x, mask)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _close(got, want)


@pytest.mark.parametrize("b,n,d,f", [(6, 28, 16, 16), (4, 5, 3, 7)])
def test_dot_graph_bwd_plain_bf16_matches_pallas_interpret(b, n, d, f):
    rng = np.random.default_rng(n + 1)
    (h, x, mask, g), (jh, jx, jm, jg) = _bf16(
        rng.normal(size=(b, n, d)) * d ** -0.25, rng.normal(size=(b, n, f)),
        rng.uniform(size=(n, n)), rng.normal(size=(b, n, f)))
    want = fused_dot_graph_spmm_bwd_pallas(jh, jx, jm, jg, interpret=True)
    got = fused_gnn.fused_dot_graph_spmm_bwd_plain(h, x, mask, g)
    for name, a, w in zip(("dh", "dx", "dmask"), got, want):
        assert a.dtype == BF, name
        _close(a, w, name)


def _pallas_lstm_bf16(xg, w, dys, dcf):
    """The Pallas recurrence's bf16 semantics, in interpret mode. Its
    kernels store the fp32 h and c into bf16 refs without a cast, which
    interpret mode refuses, so they run in fp32 on the bf16 values and the
    stored trajectory is rounded as the kernel stores it: the forward's ys
    and c_fin rounded, the backward recomputing from the rounded ys and cs
    (``_bwd`` on its residuals), dxg and dW rounded once."""
    xg32, w32 = (jnp.asarray(a, jnp.float32) for a in (xg, w))
    ys_k, cs_k, _ = jax_lstm._run_fwd(xg32, w32, True)
    rnd = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    (ys, c_fin), _ = jax_lstm._fwd(xg32, w32, True)
    res = (xg32, w32, rnd(ys_k).astype(jnp.float32),
           rnd(cs_k).astype(jnp.float32))
    dxg, dw = jax_lstm._bwd(True, res, (jnp.asarray(dys, jnp.float32),
                                        jnp.asarray(dcf, jnp.float32)))
    return rnd(ys), rnd(c_fin), rnd(dxg), rnd(dw)


@pytest.mark.parametrize("t,b,h", [(5, 3, 8), (4, 2, 24)])
def test_lstm_plain_bf16_matches_pallas_semantics(t, b, h):
    """The forward and the VJP of the plain bf16 recurrence against the
    Pallas kernel's bf16 semantics (:func:`_pallas_lstm_bf16`); the VJP on
    the port's own stored trajectory."""
    rng = np.random.default_rng(t * b)
    (xg, w, dys, dcf), jarrays = _bf16(
        rng.normal(size=(t, 2, b, 4 * h)), rng.normal(size=(2, h, 4 * h))
        * 0.2, rng.normal(size=(t, 2, b, h)), rng.normal(size=(2, b, h)))
    want = _pallas_lstm_bf16(*jarrays)
    ys, cs = fused_lstm.lstm_trajectory_plain(xg, w)
    dxg, dw = fused_lstm.lstm_recurrence_bwd_plain(xg, w, ys, cs, dys, dcf)
    for name, got, ref in zip(("ys", "c_fin", "dxg", "dw"),
                              (ys, cs[-1], dxg, dw), want):
        assert got.dtype == BF, name
        _close(got, ref, name)


def test_lstm_plain_bf16_carries_fp32_and_stores_bf16():
    """ys at bf16 is the fp32 trajectory of the bf16 inputs, rounded once
    a step (the carry is not rounded); dW at bf16 is summed in fp64."""
    rng = np.random.default_rng(3)
    (xg, w), _ = _bf16(rng.normal(size=(6, 2, 3, 16)),
                       rng.normal(size=(2, 4, 16)) * 0.3)
    ys, cs = fused_lstm.lstm_trajectory_plain(xg, w)
    ys32, cs32 = fused_lstm.lstm_trajectory_plain(xg.float(), w.float())
    assert torch.equal(ys, ys32.to(BF)) and torch.equal(cs, cs32.to(BF))


@pytest.mark.parametrize("adj", ["per-graph", "shared"])
def test_gat_plain_bf16_matches_pallas_interpret(adj):
    rng = np.random.default_rng(5)
    b, n, d = 4, 14, 9
    a = (rng.uniform(size=(b, n, n) if adj == "per-graph" else (n, n))
         > 0.5)
    (wh, f1, f2, am), (jwh, jf1, jf2, jam) = _bf16(
        rng.normal(size=(b, n, d)), rng.normal(size=(b, n)),
        rng.normal(size=(b, n)), a)
    want = fused_gat_pallas(jwh, jf1, jf2, jam, 0.3, 0.1, interpret=True)
    bias = torch.tensor(0.3).to(BF)
    got = fused_gat.fused_gat_plain(wh, f1, f2, am, bias, 0.1)
    assert got.dtype == BF
    _close(got, want)


def test_wrappers_take_one_dtype():
    """fp32 or bf16, every floating operand in one dtype; the fakes keep
    it (torch.export traces the bf16 program)."""
    h = torch.zeros(2, 5, 3, dtype=BF)
    with pytest.raises(TypeError, match="one dtype"):
        fused_gnn.fused_dot_graph_spmm(h, torch.zeros(2, 5, 4),
                                       torch.zeros(5, 5, dtype=BF))
    with pytest.raises(TypeError, match="one dtype"):
        fused_lstm.lstm_recurrence(torch.zeros(3, 2, 1, 8, dtype=BF),
                                   torch.zeros(2, 2, 8))
    with pytest.raises(TypeError, match="one dtype"):
        fused_gat.fused_gat(torch.zeros(1, 3, 2, dtype=BF),
                            torch.zeros(1, 3, dtype=BF),
                            torch.zeros(1, 3, dtype=BF), torch.ones(3, 3),
                            torch.zeros(1, dtype=BF), 0.1)
    with torch.device("meta"):
        out = fused_gnn.fused_dot_graph_spmm(
            torch.zeros(2, 5, 3, dtype=BF), torch.zeros(2, 5, 4, dtype=BF),
            torch.zeros(5, 5, dtype=BF))
    assert out.dtype == BF and out.shape == (2, 5, 4)


def test_wrappers_on_the_cpu_count_no_launch_at_bf16():
    before = [(w.launches, w.bf16_launches) for w in
              (fused_gnn.fused_dot_graph_spmm, fused_lstm.lstm_recurrence,
               fused_gat.fused_gat)]
    fused_gnn.fused_dot_graph_spmm(*(torch.ones(s, dtype=BF) for s in
                                     ((2, 4, 3), (2, 4, 3), (4, 4))))
    fused_lstm.lstm_recurrence(torch.ones(3, 2, 1, 8, dtype=BF),
                               torch.ones(2, 2, 8, dtype=BF))
    assert before == [(w.launches, w.bf16_launches) for w in
                      (fused_gnn.fused_dot_graph_spmm,
                       fused_lstm.lstm_recurrence, fused_gat.fused_gat)]


# ------------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("layer", ["last", "ncl"])
def test_batch_norm_bf16_normalises_in_fp32_and_keeps_fp32_statistics(layer):
    """flax's BatchNorm at bf16: statistics and normalisation in fp32 from
    the bf16 input, the running statistics' EMA in fp32, the output rounded
    once; in eval the statistics as stored (bf16 where a serving model
    cast them)."""
    torch.manual_seed(0)
    bn = BatchNorm1d(6) if layer == "last" else BatchNormNCL(6)
    ref = BatchNorm1d(6) if layer == "last" else BatchNormNCL(6)
    ref.load_state_dict(bn.state_dict())
    shape = (5, 7, 6) if layer == "last" else (5, 6, 7)
    x = (torch.randn(shape) * 3 + 1).to(BF)
    out = bn.train()(x)
    want = ref.train()(x.float())
    assert out.dtype == BF and bn.running_mean.dtype == torch.float32
    assert torch.equal(out, want.to(BF))
    assert torch.equal(bn.running_mean, ref.running_mean)
    assert torch.equal(bn.running_var, ref.running_var)
    assert int(bn.num_batches_tracked) == 1
    bn16 = bn.to(BF).eval()
    assert bn16(x).dtype == BF and torch.isfinite(bn16(x).float()).all()


# ----------------------------------------------- steps against JAX at bf16


def _jax_bf16_grad_and_loss(method, params, stats, x, y):
    """The JAX engine's bf16 training loss (its ``_compute_cast`` of the
    parameters and the input, the output in fp32) and its gradient in the
    fp32 parameters; dropout as the caller patched it."""
    weight = jalgorithms.resolve_aux_weight(
        jalgorithms.get_algorithm_spec(method), TRAIN_PARAMS)
    model = jax_model(method)
    cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, t)

    def loss_fn(p):
        out, _ = model.apply({"params": cast(p), "batch_stats": stats},
                             cast(jnp.asarray(x)), train=True,
                             mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(0)})
        out = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), out)
        pred, aux = out if isinstance(out, tuple) else (out, None)
        loss = jnp.mean((pred - y) ** 2)
        return loss + weight * aux if aux is not None and weight else loss
    loss, grad = jax.value_and_grad(loss_fn)(params)
    return float(loss), numpy_tree(grad)


@pytest.mark.parametrize("method", ["FC_STGNN", "LOGO", "STAGNN"])
def test_bf16_steps_match_jax_bf16_engine(method, monkeypatch):
    """From the JAX engine's initial weights, dropout off on both sides:
    the first bf16 step's loss and gradient against the JAX package's, then
    5 bf16 steps' losses against its ``Engine(precision="bf16")``'s; the
    port's master parameters, Adam state and BatchNorm statistics stay
    fp32."""
    monkeypatch.setattr(jax_basic.Dropout, "__call__",
                        lambda self, x, train=False: x)
    rng = np.random.default_rng(7)
    batches = [(x_rows(4, 100 + s, method),
                rng.uniform(size=(4, 1)).astype(np.float32))
               for s in range(5)]
    jeng = jengine.Engine(jax_model(method),
                          jalgorithms.get_algorithm_spec(method),
                          TRAIN_PARAMS, seed=0, precision="bf16")
    state = jeng.init_state(batches[0][0])
    start = numpy_tree(state.params)
    port = Engine(no_dropout(port_model(method, {
        "params": start, "batch_stats": numpy_tree(state.batch_stats)})),
                  get_algorithm_spec(method), TRAIN_PARAMS, seed=0,
                  device="cpu", precision="bf16")

    x, y = batches[0]
    jloss, jgrad = _jax_bf16_grad_and_loss(method, start, state.batch_stats,
                                           x, y)
    model = no_dropout(port_model(method, {
        "params": start, "batch_stats": numpy_tree(state.batch_stats)}))
    probe = Engine(model, get_algorithm_spec(method), TRAIN_PARAMS,
                   device="cpu", precision="bf16")
    model.train()
    loss = probe._loss(probe.forward(torch.from_numpy(x)),
                       torch.from_numpy(y))
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), jloss, rtol=FIRST_LOSS_RTOL)
    sd = model.state_dict()
    sd.update({k: p.grad for k, p in model.named_parameters()})
    got = jax.tree_util.tree_leaves_with_path(numpy_tree(
        import_torch_state_dict(method, sd, hp(method))["params"]))
    want = dict(jax.tree_util.tree_leaves_with_path(jgrad))
    g = np.concatenate([np.ravel(leaf) for _, leaf in got])
    w = np.concatenate([np.ravel(want[path]) for path, _ in got])
    assert len(got) == len(want)
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel < GRAD_NORM_RTOL, rel

    jax_losses, port_losses = [], []
    for step, (x, y) in enumerate(batches, start=1):
        state, jl = jeng.run_epoch(state, x, y, step, shuffle=False)
        jax_losses.append(jl)
        port_losses.append(port.run_epoch(x, y, step, shuffle=False))
    assert np.all(np.isfinite(port_losses))
    np.testing.assert_allclose(port_losses, jax_losses, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    for k, v in port.model.state_dict().items():
        assert not v.is_floating_point() or v.dtype == torch.float32, k
    for st in port.optimizer.state_dict()["state"].values():
        for k, v in st.items():
            assert v.dtype == torch.float32, k


# ------------------------------------------------------- every method


@pytest.mark.parametrize("method", list(MODELS))
def test_every_method_takes_a_bf16_step_and_eval_forward(method):
    """One bf16 train step and a bf16 eval forward of each of the 21
    methods at the bank's widths (mirrors tests/test_bf16.py:37-81): the
    forward runs in bf16 (its output bf16), the loss and the predictions
    are finite fp32, the master parameters and BatchNorm statistics fp32."""
    torch.manual_seed(0)
    engine = Engine(build_model(method, *cell(method)),
                    get_algorithm_spec(method), TRAIN_PARAMS, device="cpu",
                    precision="bf16")
    x = torch.from_numpy(x_rows(4, 1, method))
    raw = []
    hook = engine.model.register_forward_hook(
        lambda m, i, o: raw.append(o[0] if isinstance(o, tuple) else o))
    loss = engine.train_step(x, torch.rand(4, 1))
    preds = engine.evaluate(x.numpy())
    hook.remove()
    assert [o.dtype for o in raw] == [BF, BF]
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert preds.dtype == np.float32 and preds.shape == (4,)
    assert np.isfinite(preds).all()
    for k, v in engine.model.state_dict().items():
        assert not v.is_floating_point() or v.dtype == torch.float32, k


def test_bf16_eval_forward_is_the_serving_model():
    """Engine.evaluate at bf16 reads the BatchNorm statistics rounded to
    bf16, as JAX's eval and the bf16 serving model do: both give the same
    predictions."""
    torch.manual_seed(0)
    model = build_model("FC_STGNN", "CMAPSS", "FD001")
    engine = Engine(model, get_algorithm_spec("FC_STGNN"), TRAIN_PARAMS,
                    device="cpu", precision="bf16")
    x = x_rows(6, 2)
    engine.train_step(torch.from_numpy(x), torch.rand(6, 1))
    served = export.serving_model("FC_STGNN", "CMAPSS", "FD001",
                                  engine.model.state_dict(),
                                  precision="bf16", device="cpu")
    assert served.meta["precision"] == "bf16"
    np.testing.assert_array_equal(served(x), engine.evaluate(x))


def test_bf16_forward_runs_the_constants_in_bf16():
    """The constant buffers (FC_STGNN's decay masks and PE) are cast with
    the parameters, so the dot-graph operator gets every operand in bf16;
    the BatchNorm running statistics are not cast in training."""
    model = build_model("FC_STGNN", "CMAPSS", "FD001")
    names = precision.cast_buffer_names(model)
    assert {"pe", "MPNN1.mask", "MPNN2.mask"} <= names
    assert not any(k.endswith(("running_mean", "running_var"))
                   for k in names)
    seen = []
    orig = fused_gnn.fused_dot_graph_spmm_plain

    def spy(h, x, mask):
        seen.append((h.dtype, x.dtype, mask.dtype))
        return orig(h, x, mask)
    fused_gnn.fused_dot_graph_spmm_plain = spy
    try:
        params = precision.to_bf16(dict(model.named_parameters()))
        buffers = precision.to_bf16({k: b for k, b in
                                     model.named_buffers() if k in names})
        with torch.no_grad():
            functional_call(model.eval(), (params, buffers),
                            (torch.from_numpy(x_rows(2, 0)).to(BF),))
    finally:
        fused_gnn.fused_dot_graph_spmm_plain = orig
    assert seen and all(t == (BF, BF, BF) for t in seen)


def test_precision_guidance_warns_only_where_measured_slower(monkeypatch):
    assert precision.bf16_guidance("FC_STGNN", "NCMAPSS") is None
    monkeypatch.setitem(precision.BF16_MEASURED_GAIN, ("X", "CMAPSS"),
                        (0.5, "a card, 700 W"))
    monkeypatch.setitem(precision.BF16_MEASURED_GAIN, ("Y", "CMAPSS"),
                        (1.2, "a card, 700 W"))
    assert "0.50x" in precision.bf16_guidance("X", "CMAPSS")
    assert precision.bf16_guidance("Y", "CMAPSS") is None
    monkeypatch.setitem(precision.VECTORIZED_MEASURED_GAIN, ("X", "CMAPSS"),
                        (0.8, "a card, 700 W"))
    assert "0.80x" in precision.vectorized_guidance("X", "CMAPSS")
    with pytest.raises(ValueError, match="precision"):
        Engine(build_model("STGNN", "CMAPSS", "FD001"),
               get_algorithm_spec("STGNN"), TRAIN_PARAMS, device="cpu",
               precision="fp16")


def test_layer_norm_gelu_and_the_stft_at_bf16():
    """LayerNorm (DVGTformer) at bf16 is the fp32 LayerNorm of the bf16
    values rounded once, as flax's reduces in fp32; the erfc GELU keeps
    bf16; the STFT and the FFT features transform in fp32 and round the
    magnitudes to bf16, as the JAX signal layer does."""
    from gnn_rul_tpu_torch.nn.basic import GELU
    from gnn_rul_tpu_torch.signal.features import (frequency_features_8,
                                                   sed_features)
    from gnn_rul_tpu_torch.signal.stft import stft_magnitude
    torch.manual_seed(0)
    ln = torch.nn.LayerNorm(10)
    torch.nn.init.normal_(ln.weight)
    x = (torch.randn(6, 10) * 3).to(BF)
    got = ln.to(BF)(x)
    want = torch.nn.functional.layer_norm(x.float(), (10,), ln.weight.float(),
                                          ln.bias.float())
    assert got.dtype == BF and torch.equal(got, want.to(BF))
    g = GELU()(x)
    assert g.dtype == BF
    _close(g, GELU()(x.float()))
    sig = torch.rand(3, 256).to(BF)
    mag = stft_magnitude(sig, 64)
    assert mag.dtype == BF
    window = torch.hann_window(64, periodic=True, dtype=torch.float64)
    want = torch.stft(sig.float(), 64, hop_length=64, win_length=64,
                      window=window.to(BF).float(), center=True,
                      pad_mode="reflect", return_complex=True).abs()
    assert torch.equal(mag, want.to(BF))
    assert frequency_features_8(sig).dtype == BF
    assert sed_features(sig, 4, 4).dtype == BF


def test_vectorized_bf16_step_equals_sequential_bf16_steps():
    """VectorizedEngine(precision="bf16"): one step of two seeds, dropout
    on, against each seed's bf16 step on its own Engine; the stacked master
    parameters stay fp32."""
    from gnn_rul_tpu_torch.train.vectorized import VectorizedEngine
    spec = get_algorithm_spec("FC_STGNN")
    make = lambda: build_model("FC_STGNN", "CMAPSS", "FD001")  # noqa: E731
    xs = torch.from_numpy(np.stack([x_rows(4, 10 + s) for s in (0, 1)]))
    ys = torch.from_numpy(np.random.default_rng(3).uniform(
        size=(2, 4, 1)).astype(np.float32))
    veng = VectorizedEngine(make, spec, TRAIN_PARAMS, [0, 1], device="cpu",
                            precision="bf16")
    losses = veng.train_step(xs, ys)
    assert all(p.dtype == torch.float32 for p in veng.params.values())
    for i, s in enumerate((0, 1)):
        torch.manual_seed(s)
        eng = Engine(make(), spec, TRAIN_PARAMS, seed=s, device="cpu",
                     precision="bf16")
        loss = eng.train_step(xs[i], ys[i])
        np.testing.assert_allclose(float(losses[i]), float(loss), rtol=2e-3,
                                   atol=1e-4)
