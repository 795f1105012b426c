"""The port's whole-recurrence Bi-LSTM (gnn_rul_tpu_torch.ops.kernels.
fused_lstm, gnn_rul_tpu_torch.nn.recurrent) against the JAX package's, on
the same seeded numpy inputs. The wrapper runs its plain versions here (CPU
tensors); its CUDA kernels are held against those plain versions on the
card by chip_smoke.py."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu.nn.recurrent import _LSTMParams
from gnn_rul_tpu.nn.recurrent import bilstm_fused as jax_bilstm_fused
from gnn_rul_tpu.ops.pallas.fused_lstm import (lstm_recurrence_pallas,
                                               lstm_recurrence_reference)
from gnn_rul_tpu_torch.nn.recurrent import LSTMParams, bilstm_fused
from gnn_rul_tpu_torch.ops.kernels import fused_lstm
from gnn_rul_tpu_torch.ops.kernels.fused_lstm import (
    lstm_gates_plain, lstm_recurrence, lstm_recurrence_bwd_plain,
    lstm_recurrence_plain, lstm_sweep_plain, lstm_trajectory_plain)

torch.set_num_threads(1)

# (T, B, H): the cases of tests/test_pallas_lstm.py, H = 192, whose W_hh
# (589,824 B) exceeds a Hopper block's shared memory, and a single step.
CASES = [(12, 24, 30), (10, 13, 60), (7, 8, 8), (3, 4, 192), (1, 5, 16)]


def _np(a):
    return np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a)


def _inputs(t, b, h, seed=0):
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(t, 2, b, 4 * h)).astype(np.float32)
    w = (rng.normal(size=(2, h, 4 * h)) * 0.2).astype(np.float32)
    return xg, w


def _jax_fn(name):
    if name == "reference":
        return lstm_recurrence_reference
    return lambda xg, w: lstm_recurrence_pallas(xg, w, True)


@pytest.mark.parametrize("t,b,h", CASES)
@pytest.mark.parametrize("jax_fn", ["reference", "pallas"])
def test_forward_matches_jax(t, b, h, jax_fn):
    xg, w = _inputs(t, b, h)
    want_ys, want_cf = _jax_fn(jax_fn)(jnp.asarray(xg), jnp.asarray(w))
    got_ys, got_cf = lstm_recurrence(torch.from_numpy(xg),
                                     torch.from_numpy(w))
    assert got_ys.shape == (t, 2, b, h) and got_cf.shape == (2, b, h)
    np.testing.assert_allclose(_np(got_ys), _np(want_ys), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(_np(got_cf), _np(want_cf), atol=1e-6,
                               rtol=1e-6)


def _port_grads(fn, xg, w):
    """d/d(xg, w) of sum(sin(ys)) + sum(cos(c_fin)): both outputs used."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xg, w)]
    ys, cf = fn(*leaves)
    (torch.sin(ys).sum() + torch.cos(cf).sum()).backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("t,b,h", CASES)
@pytest.mark.parametrize("jax_fn", ["reference", "pallas"])
def test_gradients_match_jax(t, b, h, jax_fn):
    xg, w = _inputs(t, b, h, seed=1)
    fn = _jax_fn(jax_fn)

    def loss(a, b_):
        ys, cf = fn(a, b_)
        return jnp.sum(jnp.sin(ys)) + jnp.sum(jnp.cos(cf))

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xg), jnp.asarray(w))
    got = _port_grads(lstm_recurrence, xg, w)
    for g, r in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(r), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("t,b,h", CASES)
def test_bwd_plain_equals_autograd_of_plain(t, b, h):
    xg, w = _inputs(t, b, h, seed=2)
    want = _port_grads(lstm_recurrence_plain, xg, w)
    txg, tw = torch.from_numpy(xg), torch.from_numpy(w)
    ys, cs = lstm_trajectory_plain(txg, tw)
    # The cotangents of sum(sin(ys)) + sum(cos(c_fin)).
    dxg, dw = lstm_recurrence_bwd_plain(txg, tw, ys, cs, torch.cos(ys),
                                        -torch.sin(cs[-1]))
    for g, r in zip((dxg, dw), want):
        np.testing.assert_allclose(_np(g), _np(r), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("t,b,h", CASES)
def test_gates_plain_matches_a_recompute_from_the_jax_trajectory(t, b, h):
    """The gate pass: act(xg[t] + ys[t-1] @ w_hh) of every step, from the
    trajectory of lstm_recurrence_reference, recomputed step by step."""
    xg, w = _inputs(t, b, h, seed=8)
    ys, _ = lstm_recurrence_reference(jnp.asarray(xg), jnp.asarray(w))
    ys = np.array(ys)
    want, h_prev = [], jnp.zeros((2, b, h), jnp.float32)
    for step in range(t):
        pre = jnp.asarray(xg[step]) + jnp.einsum("dbh,dhg->dbg", h_prev,
                                                  jnp.asarray(w))
        i, f, g, o = jnp.split(pre, 4, axis=-1)
        want.append(jnp.concatenate([jax.nn.sigmoid(i), jax.nn.sigmoid(f),
                                     jnp.tanh(g), jax.nn.sigmoid(o)], -1))
        h_prev = ys[step]
    got = lstm_gates_plain(torch.from_numpy(xg), torch.from_numpy(w),
                           torch.from_numpy(ys))
    assert got.shape == (t, 2, b, 4 * h)
    np.testing.assert_allclose(_np(got), _np(jnp.stack(want)), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(_np(lstm_recurrence.gates(
        torch.from_numpy(xg), torch.from_numpy(w), torch.from_numpy(ys))),
        _np(got))


@pytest.mark.parametrize("t,b,h", CASES)
@pytest.mark.parametrize("jax_fn", ["reference", "pallas"])
def test_two_phase_backward_matches_jax_grad(t, b, h, jax_fn):
    """The gate pass then the sweep, called directly on the forward's saved
    trajectory, against jax.grad."""
    xg, w = _inputs(t, b, h, seed=9)
    fn = _jax_fn(jax_fn)

    def loss(a, b_):
        ys, cf = fn(a, b_)
        return jnp.sum(jnp.sin(ys)) + jnp.sum(jnp.cos(cf))

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xg), jnp.asarray(w))
    txg, tw = torch.from_numpy(xg), torch.from_numpy(w)
    ys, cs = lstm_trajectory_plain(txg, tw)
    dys, dcf = torch.cos(ys), -torch.sin(cs[-1])
    got = lstm_sweep_plain(lstm_gates_plain(txg, tw, ys), tw, ys, cs, dys,
                           dcf)
    for g, r in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(r), atol=1e-5, rtol=1e-5)
    for g, r in zip(lstm_recurrence_bwd_plain(txg, tw, ys, cs, dys, dcf),
                    got):
        np.testing.assert_array_equal(_np(g), _np(r))


def test_unused_final_state_counts_as_a_zero_cotangent():
    xg, w = _inputs(6, 5, 8, seed=4)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xg, w)]
    ys, _ = lstm_recurrence(*leaves)
    torch.sin(ys).sum().backward()
    ys_p, cs_p = lstm_trajectory_plain(*map(torch.from_numpy, (xg, w)))
    dxg, dw = lstm_recurrence_bwd_plain(
        torch.from_numpy(xg), torch.from_numpy(w), ys_p, cs_p,
        torch.cos(ys_p), torch.zeros_like(cs_p[-1]))
    np.testing.assert_array_equal(_np(leaves[0].grad), _np(dxg))
    np.testing.assert_array_equal(_np(leaves[1].grad), _np(dw))


def test_wrapper_on_cpu_counts_no_launch():
    xg, w = map(torch.from_numpy, _inputs(5, 3, 8, seed=5))
    xg.requires_grad_()
    ys, cf = lstm_recurrence(xg, w)
    (ys.sum() + cf.sum()).backward()
    assert lstm_recurrence.launches == 0
    assert lstm_recurrence.bwd_launches == 0


def test_wrapper_rejects_what_the_kernels_do_not_take():
    xg, w = map(torch.from_numpy, _inputs(3, 2, 8, seed=6))
    with pytest.raises(TypeError):
        lstm_recurrence(xg.double(), w)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_recurrence(xg.transpose(0, 2).contiguous().transpose(0, 2), w)
    with pytest.raises(ValueError, match="does not match"):
        lstm_recurrence(xg, w[:, :4].contiguous())
    with pytest.raises(ValueError, match="nonzero"):
        lstm_recurrence(xg[:0], w)
    h = fused_lstm.MAX_HIDDEN + 1
    with pytest.raises(ValueError, match="H <="):
        lstm_recurrence(torch.zeros(1, 2, 1, 4 * h), torch.zeros(2, h, 4 * h))


def test_lstm_params_carry_nn_lstm_names_and_init():
    d, h = 9, 16
    got = LSTMParams(d, h, bidirectional=True).state_dict()
    want = torch.nn.LSTM(d, h, bidirectional=True, batch_first=True)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.state_dict().items()}
    bound = 1.0 / np.sqrt(h)
    for v in got.values():
        assert float(v.abs().max()) <= bound and float(v.std()) > bound / 4


class _JaxBi(fnn.Module):
    """tests/test_pallas_lstm.py's harness: both outputs and final states
    consumed."""
    impl: str

    @fnn.compact
    def __call__(self, x):
        pf = _LSTMParams(16, name="f")(x.shape[-1])
        pb = _LSTMParams(16, name="b")(x.shape[-1])
        f, b, ((hf, cf), (hb, cb)) = jax_bilstm_fused(x, pf, pb,
                                                      impl=self.impl)
        return f + b + (cf + cb + hf * hb)[:, None, :]


def _port_bi(params):
    layer = LSTMParams(9, 16, bidirectional=True)
    with torch.no_grad():
        for sfx, name in (("", "f"), ("_reverse", "b")):
            p = params[name]
            getattr(layer, "weight_ih_l0" + sfx).copy_(
                torch.from_numpy(np.asarray(p["w_ih"]).T.copy()))
            getattr(layer, "weight_hh_l0" + sfx).copy_(
                torch.from_numpy(np.asarray(p["w_hh"]).T.copy()))
            getattr(layer, "bias_ih_l0" + sfx).copy_(
                torch.from_numpy(np.array(p["b_ih"])))
            getattr(layer, "bias_hh_l0" + sfx).copy_(
                torch.from_numpy(np.array(p["b_hh"])))

    def apply(x):
        f, b, ((hf, cf), (hb, cb)) = bilstm_fused(
            x, layer.direction(), layer.direction(True))
        return f + b + (cf + cb + hf * hb)[:, None, :]

    return layer, apply


@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_bilstm_fused_matches_jax(impl):
    x = np.random.default_rng(1).normal(size=(6, 11, 9)).astype(np.float32)
    params = _JaxBi(impl="scan").init(jax.random.PRNGKey(0),
                                      jnp.asarray(x))["params"]
    want = _JaxBi(impl=impl).apply({"params": params}, jnp.asarray(x))
    layer, apply = _port_bi(params)
    got = apply(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)

    jgrads = jax.grad(lambda p: jnp.sum(_JaxBi(impl=impl).apply(
        {"params": p}, jnp.asarray(x)) ** 2))(params)
    (got ** 2).sum().backward()
    for sfx, name in (("", "f"), ("_reverse", "b")):
        g = jgrads[name]
        for port_name, jax_name, transpose in (
                ("weight_ih_l0", "w_ih", True), ("weight_hh_l0", "w_hh", True),
                ("bias_ih_l0", "b_ih", False), ("bias_hh_l0", "b_hh", False)):
            want_g = np.asarray(g[jax_name])
            got_g = _np(getattr(layer, port_name + sfx).grad)
            np.testing.assert_allclose(got_g, want_g.T if transpose else want_g,
                                       atol=1e-5, rtol=1e-5,
                                       err_msg=port_name + sfx)


@pytest.mark.cuda
def test_cuda_tensor_reaches_the_kernels():
    """On the card the wrapper launches its kernels; here it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the kernels run only on an NVIDIA GPU")
    xg, w = _inputs(9, 7, 30, seed=7)
    txg = torch.from_numpy(xg).cuda().requires_grad_()
    tw = torch.from_numpy(w).cuda()
    before = (lstm_recurrence.launches, lstm_recurrence.bwd_launches)
    ys, cf = lstm_recurrence(txg, tw)
    (torch.sin(ys).sum() + torch.cos(cf).sum()).backward()
    torch.cuda.synchronize()
    assert lstm_recurrence.launches == before[0] + 1
    assert lstm_recurrence.bwd_launches == \
        before[1] + fused_lstm.BWD_LAUNCHES_PER_CALL
    want = _port_grads(lstm_recurrence_plain, xg, w)
    np.testing.assert_allclose(_np(ys.cpu()), _np(lstm_recurrence_plain(
        *map(torch.from_numpy, (xg, w)))[0]), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(txg.grad.cpu()), _np(want[0]), atol=1e-5,
                               rtol=1e-4)
