"""The port's graph attention and the blocks around it against the JAX
package, on the CPU: ops/kernels/fused_gat.py (the plain version, the
wrapper and its autograd backward) against fused_gat_reference, the Pallas
kernel in interpret mode and fused_gat_trainable's gradients; then
GraphAttentionLayer, GAT, GCNLayer, TemporalConvNet and
covariance_threshold_graph on the same weights and seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu.compat import torch_import
from gnn_rul_tpu.nn.attention import GAT as JaxGAT
from gnn_rul_tpu.nn.attention import GraphAttentionLayer as JaxGATLayer
from gnn_rul_tpu.nn.gnn_blocks import GCNLayer as JaxGCNLayer
from gnn_rul_tpu.nn.tcn import TemporalConvNet as JaxTCN
from gnn_rul_tpu.ops.graphs import (
    covariance_threshold_graph as jax_covariance_threshold_graph)
from gnn_rul_tpu.ops.pallas.fused_gat import (
    fused_gat_pallas, fused_gat_reference, fused_gat_trainable)
from gnn_rul_tpu_torch.nn.attention import GAT, GraphAttentionLayer
from gnn_rul_tpu_torch.nn.gnn_blocks import GCNLayer
from gnn_rul_tpu_torch.nn.tcn import TemporalConvNet
from gnn_rul_tpu_torch.ops.graphs import covariance_threshold_graph
from gnn_rul_tpu_torch.ops.kernels import fused_gat as fused_gat_module
from gnn_rul_tpu_torch.ops.kernels.fused_gat import fused_gat, fused_gat_plain

torch.set_num_threads(1)

ATOL, RTOL = 2e-4, 1e-4

# (B, N, D, per-graph adj, bias, slope): STAGNN's per-graph adjacency, STFA's
# shared prior, ragged N, GAT_LSTM's D = 300 at GDAGDL's N = 17, and a
# negative bias at slope 0.01.
GAT_CASES = [(5, 14, 64, True, 0.3, 0.1), (6, 14, 5, False, 0.1, 0.1),
             (2, 17, 300, True, 0.2, 0.1), (3, 33, 7, False, -0.2, 0.01),
             (1, 1, 1, True, 0.0, 0.1)]
GAT_IDS = [f"B{b}-N{n}-D{d}-{'batched' if ba else 'shared'}"
           for b, n, d, ba, _, _ in GAT_CASES]


def _gat_inputs(b, n, d, batched_adj, seed):
    rng = np.random.default_rng(seed)
    wh = rng.normal(size=(b, n, d)).astype(np.float32)
    f1 = rng.normal(size=(b, n)).astype(np.float32)
    f2 = rng.normal(size=(b, n)).astype(np.float32)
    shape = (b, n, n) if batched_adj else (n, n)
    adj = (rng.uniform(size=shape) > 0.4).astype(np.float32)
    return wh, f1, f2, adj


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", GAT_CASES, ids=GAT_IDS)
def test_plain_matches_jax_reference(case):
    b, n, d, batched, bias, slope = case
    arrays = _gat_inputs(b, n, d, batched, seed=n + d)
    want = np.asarray(fused_gat_reference(*map(jnp.asarray, arrays), bias,
                                          slope))
    got = fused_gat_plain(*_t(*arrays), torch.tensor(bias), slope).numpy()
    assert got.shape == (b, n, d)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", [GAT_CASES[1], GAT_CASES[2], GAT_CASES[3]],
                         ids=[GAT_IDS[1], GAT_IDS[2], GAT_IDS[3]])
def test_wrapper_matches_pallas_interpret(case):
    """The wrapper on CPU tensors (its plain version) against the TPU
    kernel run in interpret mode, as tests/test_pallas_kernels.py runs it;
    no launch is counted."""
    b, n, d, batched, bias, slope = case
    arrays = _gat_inputs(b, n, d, batched, seed=n * d)
    want = np.asarray(fused_gat_pallas(*map(jnp.asarray, arrays), bias,
                                       slope, interpret=True))
    before = fused_gat.launches
    got = fused_gat(*_t(*arrays), torch.tensor(bias), slope).numpy()
    assert fused_gat.launches == before
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", GAT_CASES[:4], ids=GAT_IDS[:4])
def test_backward_matches_jax_grad(case):
    """The autograd backward (a recompute through the plain version)
    against jax.grad of fused_gat_trainable, whose _bwd recomputes through
    fused_gat_reference: wh, f1, f2, adj and bias."""
    b, n, d, batched, bias, slope = case
    wh, f1, f2, adj = _gat_inputs(b, n, d, batched, seed=7 * n + d)
    g = np.random.default_rng(d).normal(size=(b, n, d)).astype(np.float32)

    def loss(*args):
        return jnp.sum(fused_gat_trainable(*args, slope) * g)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (wh, f1, f2, adj)), jnp.float32(bias))
    inputs = [t.requires_grad_() for t in _t(wh, f1, f2, adj)]
    tbias = torch.tensor(bias, requires_grad=True)
    out = fused_gat(*inputs, tbias, slope)
    (out * torch.from_numpy(g)).sum().backward()
    for name, got, w in zip(("wh", "f1", "f2", "adj", "bias"),
                            [t.grad for t in inputs] + [tbias.grad], want):
        assert got.shape == np.shape(w), name
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


def test_backward_returns_only_what_is_asked():
    wh, f1, f2, adj = _t(*_gat_inputs(2, 6, 4, True, seed=1))
    wh.requires_grad_()
    bias = torch.tensor(0.1, requires_grad=True)
    fused_gat(wh, f1, f2, adj, bias, 0.1).sum().backward()
    assert wh.grad is not None and bias.grad is not None
    assert f1.grad is None and f2.grad is None and adj.grad is None


@pytest.mark.parametrize("bad,error", [
    ("float64", TypeError), ("strided", ValueError), ("adj_shape", ValueError),
    ("bias_float", TypeError), ("bias_two", ValueError),
    ("f1_shape", ValueError)])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, error):
    wh, f1, f2, adj = _t(*_gat_inputs(2, 5, 3, False, seed=0))
    bias = torch.tensor(0.0)
    if bad == "float64":
        wh = wh.double()
    elif bad == "strided":
        wh = wh.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "adj_shape":
        adj = adj[:4, :4].contiguous()
    elif bad == "bias_float":
        bias = 0.0
    elif bad == "bias_two":
        bias = torch.zeros(2)
    else:
        f1 = f1[:, :4].contiguous()
    with pytest.raises(error):
        fused_gat(wh, f1, f2, adj, bias, 0.1)


@pytest.mark.cuda
def test_cuda_tensor_reaches_the_kernel():
    """On the card the wrapper launches its kernel, and agrees with the
    plain version on both adjacency layouts; here it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the kernel runs only on an NVIDIA GPU")
    for b, n, d, batched, bias, slope in GAT_CASES:
        arrays = [t.cuda() for t in _t(*_gat_inputs(b, n, d, batched, 3))]
        tbias = torch.tensor(bias, device="cuda")
        before = fused_gat.launches
        got = fused_gat(*arrays, tbias, slope)
        torch.cuda.synchronize()
        assert fused_gat.launches == before + 1
        want = fused_gat_plain(*arrays, tbias, slope)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------- layers

def _prefixed(module, prefix="m"):
    return {f"{prefix}.{k}": v for k, v in module.state_dict().items()}


def _jax_gat_layer_params(layer):
    return torch_import.gat_layer(_prefixed(layer), "m")


@pytest.mark.parametrize("final_leaky_relu", [False, True])
@pytest.mark.parametrize("batched_adj", [True, False])
def test_graph_attention_layer_matches_jax(batched_adj, final_leaky_relu):
    torch.manual_seed(0)
    layer = GraphAttentionLayer(9, 6, dropout=0.0,
                                final_leaky_relu=final_leaky_relu).eval()
    rng = np.random.default_rng(1)
    h = rng.normal(size=(3, 14, 9)).astype(np.float32)
    shape = (3, 14, 14) if batched_adj else (14, 14)
    adj = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    jlayer = JaxGATLayer(6, final_leaky_relu=final_leaky_relu)
    want = np.asarray(jlayer.apply({"params": _jax_gat_layer_params(layer)},
                                   jnp.asarray(h), jnp.asarray(adj)))
    with torch.no_grad():
        got = layer(*_t(h, adj)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_graph_attention_layer_train_at_dropout_zero_takes_the_kernel_path(
        monkeypatch):
    """Training with attention dropout at 0 goes through fused_gat, as the
    JAX layer takes its fused path; at dropout 0.2 it takes the plain path
    with dropout before the mask, and the wrapper is not called."""
    torch.manual_seed(1)
    layer = GraphAttentionLayer(5, 4, dropout=0.0).train()
    rng = np.random.default_rng(2)
    h = rng.normal(size=(2, 7, 5)).astype(np.float32)
    adj = (rng.uniform(size=(2, 7, 7)) > 0.5).astype(np.float32)
    want = np.asarray(JaxGATLayer(4).apply(
        {"params": _jax_gat_layer_params(layer)}, jnp.asarray(h),
        jnp.asarray(adj), train=True))
    calls = []
    from gnn_rul_tpu_torch.nn import attention

    def counting(*args):
        calls.append(1)
        return fused_gat(*args)

    monkeypatch.setattr(attention, "fused_gat", counting)
    got = layer(*_t(h, adj))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)
    assert len(calls) == 1
    layer.attn_drop.p = 0.2
    layer(*_t(h, adj))
    assert len(calls) == 1
    layer.eval()(*_t(h, adj))
    assert len(calls) == 2


def test_gat_mean_of_heads_matches_jax():
    torch.manual_seed(2)
    gat = GAT(8, 5, num_heads=3).eval()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 14, 8)).astype(np.float32)
    adj = (rng.uniform(size=(4, 14, 14)) > 0.5).astype(np.float32)
    params = torch_import.gat_heads(_prefixed(gat), "m", 3)
    want = np.asarray(JaxGAT(5, 3).apply({"params": params}, jnp.asarray(x),
                                         jnp.asarray(adj)))
    with torch.no_grad():
        got = gat(*_t(x, adj)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_gcn_layer_matches_jax():
    torch.manual_seed(3)
    layer = GCNLayer(50, 16)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 14, 50)).astype(np.float32)
    adj = (rng.uniform(size=(3, 14, 14)) > 0.5).astype(np.float32)
    params = {"linear": {"Dense_0": torch_import.linear(_prefixed(layer),
                                                        "m.linear")}}
    want = np.asarray(JaxGCNLayer(16).apply({"params": params},
                                            jnp.asarray(x), jnp.asarray(adj)))
    with torch.no_grad():
        got = layer(*_t(x, adj)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("in_channels", [14, 8])
def test_temporal_conv_net_matches_jax(in_channels, train):
    """With downsample0 (14 -> 8 channels, its bias carried) and without
    (8 -> 8); eval mode on seeded running statistics, train mode on the
    batch's."""
    torch.manual_seed(4)
    tcn = TemporalConvNet(in_channels, 8, 2)
    assert (tcn.downsample0 is None) == (in_channels == 8)
    gen = torch.Generator().manual_seed(5)
    for k, v in tcn.state_dict().items():
        if k.endswith("running_mean"):
            v.copy_(torch.randn(v.shape, generator=gen) * 0.5)
        elif k.endswith("running_var"):
            v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
    sd = _prefixed(tcn)
    variables = {"params": torch_import.tcn_params(
                     sd, "m", has_downsample=in_channels != 8),
                 "batch_stats": torch_import.tcn_stats(sd, "m")}
    x = np.random.default_rng(6).normal(size=(4, in_channels, 16)).astype(
        np.float32)
    if train:
        want, _ = JaxTCN(8, 2).apply(variables, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
    else:
        want = JaxTCN(8, 2).apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tcn.train(train)(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 8, 16)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


def _min_abs_cov(x):
    xc = x.astype(np.float64) - x.mean(axis=-1, keepdims=True)
    cov = np.einsum("...nl,...ml->...nm", xc, xc) / (x.shape[-1] - 1)
    return float(np.abs(cov).min())


def test_covariance_threshold_graph_matches_jax():
    """Exactly equal, on inputs whose every covariance stays more than 1e-4
    from the threshold 0: an entry within rounding of it could flip between
    the two summation orders, and that is not what this test asks."""
    x = np.random.default_rng(7).normal(size=(6, 14, 50)).astype(np.float32)
    assert _min_abs_cov(x) > 1e-4
    want = np.asarray(jax_covariance_threshold_graph(jnp.asarray(x), 0.0))
    got = covariance_threshold_graph(torch.from_numpy(x), 0.0).numpy()
    assert got.dtype == np.float32 and got.shape == (6, 14, 14)
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diagonal(got, axis1=-2, axis2=-1) == 1.0)


# (B, N, D) -> plan keys of the attention kernel: STAGNN at batch 100 (rows
# tiled over 2 blocks a graph) and 1000 (2 graphs a block), STFA at batch
# 100 and 1000 (10 graphs a block), the two few-large-graph shapes (a row
# or two a block), and N at the kernel's limit.
GAT_PLAN_CASES = [
    ((100, 14, 64), {"graphs": 1, "rows": 7, "row_tiles": 2, "blocks": 200}),
    ((1000, 14, 64), {"graphs": 2, "rows": 14, "row_tiles": 1,
                      "blocks": 500}),
    ((2500, 14, 5), {"graphs": 10, "rows": 14, "row_tiles": 1,
                     "blocks": 250}),
    ((25000, 14, 5), {"graphs": 10, "rows": 14, "row_tiles": 1,
                      "blocks": 2500}),
    ((3, 17, 300), {"graphs": 1, "rows": 1, "row_tiles": 17, "blocks": 51}),
    ((2, 130, 16), {"graphs": 1, "rows": 2, "row_tiles": 65, "blocks": 130}),
    ((1, fused_gat_module.MAX_N, 1), {"graphs": 1, "rows": 1, "cols": 1}),
]


@pytest.mark.parametrize("shape,want", GAT_PLAN_CASES,
                         ids=[f"B{b}-N{n}-D{d}" for (b, n, d), _ in
                              GAT_PLAN_CASES])
def test_attention_plan(shape, want):
    plan = fused_gat_module.gat_plan(*shape)
    assert {k: plan[k] for k in want} == want
    b, n, d = shape
    # whole graphs a block, or one graph's rows tiled over blocks; every
    # row in a block, every column in a chunk
    assert (plan["row_tiles"] == 1 and plan["rows"] == n
            or plan["graphs"] == 1)
    assert plan["rows"] * plan["row_tiles"] >= n
    assert plan["blocks"] * plan["graphs"] >= b
    assert 1 <= plan["cols"] <= d


@pytest.mark.parametrize("axis", ["B", "N", "D"])
def test_attention_plan_footprint_fits_at_every_threshold(axis):
    """Along B at STFA's (N, D), along N at B = 140 and along D at N = 41,
    the shared memory of every plan stays within 48 KB (no opt-in needed),
    far below an H100 block's 232,448 B."""
    for v in range(1, 401):
        shape = {"B": (v, 14, 5), "N": (140, v, 16), "D": (1, 41, v)}[axis]
        assert fused_gat_module.gat_plan(*shape)["smem"] <= 48 * 1024 < \
            232448


def test_attention_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        fused_gat_module.gat_plan(2, fused_gat_module.MAX_N + 1, 1)
    with pytest.raises(ValueError):
        fused_gat_module.gat_plan(0, 14, 5)


def test_wrapper_on_cpu_takes_n_beyond_the_kernels_limit():
    """The kernel's limit on N binds only on the card: on the CPU the
    wrapper runs the plain version at any N, as the JAX reference does."""
    n = fused_gat_module.MAX_N + 1
    arrays = _gat_inputs(1, n, 1, False, seed=12)
    before = fused_gat.launches
    got = fused_gat(*_t(*arrays), torch.tensor(0.2), 0.1)
    assert fused_gat.launches == before
    assert got.shape == (1, n, 1)
    want = np.asarray(fused_gat_reference(*map(jnp.asarray, arrays), 0.2,
                                          0.1))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", GAT_CASES[:2], ids=GAT_IDS[:2])
def test_wrapper_on_cpu_runs_plain_and_counts_no_launch(case):
    b, n, d, batched, bias, slope = case
    arrays = _t(*_gat_inputs(b, n, d, batched, seed=11))
    before = fused_gat.launches
    got = fused_gat(*arrays, torch.tensor(bias), slope)
    assert fused_gat.launches == before
    np.testing.assert_array_equal(
        got.numpy(), fused_gat_plain(*arrays, torch.tensor(bias),
                                     slope).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(131, 14, 64), (132, 14, 64),
                                   (659, 14, 5), (660, 14, 5),
                                   (140, 73, 16), (140, 74, 16)])
def test_cuda_attention_each_side_of_a_plan_threshold(shape):
    """On the card the kernel agrees with the plain version on each side
    of the points where its plan changes (tiled rows to whole graphs at
    B = 132, graphs a block at STFA's shape, whole graphs to tiles at N =
    74); here it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the kernel runs only on an NVIDIA GPU")
    b, n, d = shape
    arrays = [t.cuda() for t in _t(*_gat_inputs(b, n, d, d == 64, 4))]
    tbias = torch.tensor(0.2, device="cuda")
    before = fused_gat.launches
    got = fused_gat(*arrays, tbias, 0.1)
    torch.cuda.synchronize()
    assert fused_gat.launches == before + 1
    assert fused_gat.kernel_plan(b, n, d) == fused_gat_module.gat_plan(b, n, d)
    want = fused_gat_plain(*arrays, tbias, 0.1)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5, rtol=1e-4)
