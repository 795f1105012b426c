"""The port's ops (gnn_rul_tpu_torch.ops) against the JAX package's, on the
same seeded numpy inputs. The fused dot-graph wrapper runs its plain version
here (CPU tensors); its CUDA kernel is checked against that plain version on
the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu.ops import encoding as jenc
from gnn_rul_tpu.ops import graphs as jgraphs
from gnn_rul_tpu.ops import message_passing as jmp
from gnn_rul_tpu.ops import windows as jwin
from gnn_rul_tpu.ops.pallas.fused_gnn import (
    fused_dot_graph_spmm_bwd_pallas, fused_dot_graph_spmm_packed,
    fused_dot_graph_spmm_pallas, fused_dot_graph_spmm_reference)
from gnn_rul_tpu_torch.ops import encoding, graphs, message_passing, windows
from gnn_rul_tpu_torch.ops.kernels import fused_gnn
from gnn_rul_tpu_torch.ops.kernels.fused_gnn import (
    fused_dot_graph_spmm, fused_dot_graph_spmm_bwd_plain,
    fused_dot_graph_spmm_plain)

torch.set_num_threads(1)


def _np(a):
    return np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a)


def test_patchify_exact():
    x = np.random.default_rng(0).normal(size=(3, 14, 50)).astype(np.float32)
    got = windows.patchify(torch.from_numpy(x), 2, 25)
    np.testing.assert_array_equal(_np(got), _np(jwin.patchify(x, 2, 25)))


@pytest.mark.parametrize("window,stride", [(2, 1), (2, 2), (3, 2)])
def test_sliding_time_windows_exact(window, stride):
    x = np.random.default_rng(1).normal(size=(2, 6, 5, 4)).astype(np.float32)
    got = windows.sliding_time_windows(torch.from_numpy(x), window, stride)
    want = jwin.sliding_time_windows(jnp.asarray(x), window, stride)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("num_node,window,decay", [(14, 2, 0.7), (5, 3, 0.5)])
def test_decay_mask_exact(num_node, window, decay):
    np.testing.assert_array_equal(
        _np(windows.decay_mask(num_node, window, decay)),
        _np(jwin.decay_mask(num_node, window, decay)))


@pytest.mark.parametrize("length,d_model", [(2, 16), (5, 7)])
def test_sinusoidal_encoding(length, d_model):
    np.testing.assert_allclose(
        _np(encoding.sinusoidal_encoding(length, d_model, base=100.0)),
        _np(jenc.sinusoidal_encoding(length, d_model, base=100.0)),
        atol=1e-6, rtol=1e-5)


def test_dot_graph_from_mapped_and_spmm():
    rng = np.random.default_rng(2)
    h = rng.normal(size=(3, 28, 16)).astype(np.float32)
    x = rng.normal(size=(3, 28, 16)).astype(np.float32)
    adj = graphs.dot_graph_from_mapped(torch.from_numpy(h))
    jadj = jgraphs.dot_graph_from_mapped(jnp.asarray(h))
    np.testing.assert_allclose(_np(adj), _np(jadj), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(
        _np(message_passing.spmm(adj, torch.from_numpy(x))),
        _np(jmp.spmm(jadj, jnp.asarray(x))), atol=1e-6, rtol=1e-5)


def _fused_inputs(b, n, d, f, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(b, n, d)).astype(np.float32)
    x = rng.normal(size=(b, n, f)).astype(np.float32)
    if n == 28:
        mask = np.array(jwin.decay_mask(14, 2, 0.7))
    else:
        mask = rng.uniform(size=(n, n)).astype(np.float32)
    return h, x, mask


@pytest.mark.parametrize("b,n,d,f", [(6, 28, 16, 16), (3, 1, 4, 4),
                                     (4, 5, 3, 7)])
@pytest.mark.parametrize("jax_fn", ["reference", "packed", "pallas"])
def test_fused_plain_matches_jax(b, n, d, f, jax_fn):
    h, x, mask = _fused_inputs(b, n, d, f, seed=n)
    if jax_fn == "reference":
        want = fused_dot_graph_spmm_reference(h, x, mask)
    elif jax_fn == "packed":
        want = fused_dot_graph_spmm_packed(h, x, mask, interpret=True)
    else:
        want = fused_dot_graph_spmm_pallas(h, x, mask, interpret=True)
    got = fused_dot_graph_spmm_plain(
        torch.from_numpy(h), torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    h, x, mask = _fused_inputs(6, 28, 16, 16, seed=3)
    th, tx, tm = map(torch.from_numpy, (h, x, mask))
    before = fused_dot_graph_spmm.launches
    got = fused_dot_graph_spmm(th, tx, tm)
    assert fused_dot_graph_spmm.launches == before == 0
    np.testing.assert_array_equal(
        _np(got), _np(fused_dot_graph_spmm_plain(th, tx, tm)))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    h, x, mask = map(torch.from_numpy, _fused_inputs(2, 5, 3, 7, seed=4))
    with pytest.raises(TypeError):
        fused_dot_graph_spmm(h.double(), x, mask)
    # One mask a group of graphs: 3 groups do not divide B = 2.
    with pytest.raises(ValueError, match="dividing B"):
        fused_dot_graph_spmm(h, x, mask.expand(3, 5, 5).contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fused_dot_graph_spmm(h, x, mask.t())
    wide = torch.zeros(2, 5, fused_gnn.MAX_FEAT + 1)
    with pytest.raises(ValueError, match="D, F <="):
        fused_dot_graph_spmm(wide, x, mask)
    with pytest.raises(ValueError, match="D, F <="):
        fused_dot_graph_spmm(h, wide, mask)


BWD_SHAPES = [(6, 28, 16, 16), (3, 1, 4, 4), (4, 5, 3, 7)]


@pytest.mark.parametrize("b,n,d,f", BWD_SHAPES)
@pytest.mark.parametrize("jax_fn", ["vjp", "pallas"])
def test_fused_bwd_plain_matches_jax(b, n, d, f, jax_fn):
    h, x, mask = _fused_inputs(b, n, d, f, seed=n)
    g = np.random.default_rng(n + 1).normal(size=(b, n, f)).astype(
        np.float32)
    if jax_fn == "vjp":
        _, vjp = jax.vjp(fused_dot_graph_spmm_reference, h, x, mask)
        want = vjp(g)
    else:
        dh, dx, dmask = fused_dot_graph_spmm_bwd_pallas(h, x, mask, g,
                                                        interpret=True)
        want = (dh, dx, jnp.sum(dmask, axis=0))
    dh, dx, dmask = fused_dot_graph_spmm_bwd_plain(
        *map(torch.from_numpy, (h, x, mask, g)))
    assert dmask.shape == (b, n, n)
    for got, ref in zip((dh, dx, dmask.sum(dim=0)), want):
        np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5, rtol=1e-5)


def _grads(fn, h, x, mask, g):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (h, x, mask)]
    fn(*leaves).backward(g)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("b,n,d,f", BWD_SHAPES)
def test_wrapper_gradients_on_cpu_equal_autograd_of_plain(b, n, d, f):
    h, x, mask = _fused_inputs(b, n, d, f, seed=n + 2)
    g = torch.from_numpy(np.random.default_rng(n).normal(
        size=(b, n, f)).astype(np.float32))
    got = _grads(fused_dot_graph_spmm, h, x, mask, g)
    want = _grads(fused_dot_graph_spmm_plain, h, x, mask, g)
    for a, w in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(w), atol=1e-5, rtol=1e-5)
    assert fused_dot_graph_spmm.launches == 0
    assert fused_dot_graph_spmm.bwd_launches == 0


def test_wrapper_backward_takes_a_non_contiguous_cotangent():
    h, x, mask = _fused_inputs(3, 5, 3, 7, seed=6)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        size=(7, 5, 3)).astype(np.float32)).permute(2, 1, 0)
    assert not g.is_contiguous()
    got = _grads(fused_dot_graph_spmm, h, x, mask, g)
    want = _grads(fused_dot_graph_spmm_plain, h, x, mask, g.contiguous())
    for a, w in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(w), atol=1e-5, rtol=1e-5)


def test_wrapper_skips_the_mask_gradient_of_a_buffer():
    h, x, mask = map(torch.from_numpy, _fused_inputs(2, 5, 3, 7, seed=7))
    h.requires_grad_()
    x.requires_grad_()
    fused_dot_graph_spmm(h, x, mask).sum().backward()
    assert mask.grad is None and h.grad is not None and x.grad is not None


# (N, D, F, launches) of the dot-graph backward's plan: FC_STGNN's shape in
# one launch, the kernels' largest in two.
BWD_PLAN_CASES = [(28, 16, 16, 1), (384, 128, 128, 2), (1, 3, 7, 1)]


@pytest.mark.parametrize("n,d,f,launches", BWD_PLAN_CASES)
def test_backward_launches_per_call(n, d, f, launches):
    assert fused_gnn.bwd_launches_per_call(n, d, f) == launches
    assert fused_gnn.bwd_plan(n, d, f)["launches"] == launches


def _bwd_threshold(d, f):
    n = 1
    while fused_gnn.bwd_launches_per_call(n + 1, d, f) == 1:
        n += 1
    return n


@pytest.mark.parametrize("d,f", [(16, 16), (128, 128), (3, 7)])
def test_backward_plan_footprint_fits_a_block_at_its_threshold(d, f):
    """The one-launch plan's shared memory stays within an H100 block's
    232,448 B up to its threshold in N, the two-launch plan's beyond it,
    and the launches per call change there and only there."""
    top = _bwd_threshold(d, f)
    for n in range(1, top + 3):
        plan = fused_gnn.bwd_plan(n, d, f)
        assert plan["smem"] <= fused_gnn.SMEM_LIMIT == 232448
        assert plan["launches"] == (1 if n <= top else 2)


@pytest.mark.parametrize("b,n,d,f", [(3, 28, 16, 16), (2, 5, 3, 7)])
def test_wrapper_backward_on_cpu_runs_plain_and_counts_no_launch(b, n, d, f):
    h, x, mask = map(torch.from_numpy, _fused_inputs(b, n, d, f, seed=8))
    g = torch.from_numpy(np.random.default_rng(9).normal(
        size=(b, n, f)).astype(np.float32))
    before = fused_dot_graph_spmm.bwd_launches
    got = fused_dot_graph_spmm.backward(h, x, mask, g, need_dmask=True)
    assert fused_dot_graph_spmm.bwd_launches == before == 0
    assert fused_dot_graph_spmm.bwd_calls == 0
    for a, w in zip(got, fused_dot_graph_spmm_bwd_plain(h, x, mask, g)):
        np.testing.assert_array_equal(_np(a), _np(w))


@pytest.mark.cuda
@pytest.mark.parametrize("d,f", [(16, 16), (128, 128)])
@pytest.mark.parametrize("side", [0, 1])
def test_cuda_backward_each_side_of_its_threshold(d, f, side):
    """On the card the backward launches its plan (one kernel up to the
    threshold in N, two beyond) and agrees with the plain version, dmask
    included; here it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the kernels run only on an NVIDIA GPU")
    n = _bwd_threshold(d, f) + side
    h, x, mask = (torch.from_numpy(a).cuda()
                  for a in _fused_inputs(2, n, d, f, seed=n))
    h = h * d ** -0.25
    g = torch.randn(x.shape, device="cuda")
    before = fused_dot_graph_spmm.bwd_launches
    calls = fused_dot_graph_spmm.bwd_calls
    got = fused_dot_graph_spmm.backward(h, x, mask, g, need_dmask=True)
    torch.cuda.synchronize()
    # the launches the C entry reports, against the wrapper's mirror
    assert fused_dot_graph_spmm.bwd_launches == before + 1 + side
    assert fused_dot_graph_spmm.bwd_calls == calls + 1
    assert fused_dot_graph_spmm.kernel_plan(n, d, f) == fused_gnn.bwd_plan(
        n, d, f)
    want = fused_dot_graph_spmm_bwd_plain(h, x, mask, g)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), w.cpu().numpy(),
                                   atol=1e-5, rtol=1e-4)


# (B, N, D, F) -> the forward's plan: FC_STGNN's serving and training shape
# and a request of 1000 (whole graphs, 1 and 2 a block), N = 1, a large graph
# below 132 graphs (rows tiled over 5 blocks), the kernels' largest N
# (the row-tile stream).
FWD_PLAN_CASES = [
    ((100, 28, 16, 16), {"whole": True, "graphs": 1, "rows": 28,
                         "row_tiles": 1, "blocks": 100, "smem": 10304}),
    ((1000, 28, 16, 16), {"whole": True, "graphs": 2, "rows": 28,
                          "row_tiles": 1, "blocks": 500, "smem": 17472}),
    ((7, 1, 16, 16), {"whole": True, "graphs": 1, "rows": 1,
                      "row_tiles": 1, "blocks": 7, "smem": 356}),
    ((3, 130, 16, 16), {"whole": True, "graphs": 1, "rows": 28,
                        "row_tiles": 5, "blocks": 15, "smem": 48192}),
    ((8, 384, 128, 128), {"whole": False, "graphs": 1, "rows": 8,
                          "row_tiles": 48, "blocks": 384, "smem": 36992}),
]


@pytest.mark.parametrize("shape,plan", FWD_PLAN_CASES)
def test_forward_plan(shape, plan):
    assert fused_gnn.fwd_plan(*shape) == plan


def _fwd_threshold(d, f):
    n = 1
    while fused_gnn.fwd_plan(1, n + 1, d, f)["whole"]:
        n += 1
    return n


@pytest.mark.parametrize("d,f,top", [(16, 16, 160), (128, 128, 116)])
def test_forward_whole_graph_threshold(d, f, top):
    assert _fwd_threshold(d, f) == top


@pytest.mark.parametrize("b", [2, 132, 1000])
@pytest.mark.parametrize("d,f", [(16, 16), (128, 128), (3, 7)])
def test_forward_plan_footprint_fits_a_block_at_its_threshold(b, d, f):
    """The whole-graph plan's shared memory stays within an H100 block's
    232,448 B up to its threshold in N, whatever B, and the plan turns into
    the row-tile stream there and only there."""
    top = _fwd_threshold(d, f)
    for n in range(1, top + 3):
        plan = fused_gnn.fwd_plan(b, n, d, f)
        assert plan["smem"] <= fused_gnn.SMEM_LIMIT == 232448
        assert plan["whole"] == (n <= top)


@pytest.mark.parametrize("b,n,d,f", [(1, 33, 16, 16), (3, 160, 16, 16),
                                     (131, 28, 16, 16), (132, 28, 16, 16),
                                     (1000, 5, 3, 7), (1000, 28, 16, 16),
                                     (25000, 1, 4, 4), (500, 116, 128, 128)])
def test_forward_plan_covers_every_row_once(b, n, d, f):
    """Whole graphs a block keep B / 132 blocks and about 2,048 pairs or
    outputs a block from B = 132; below it a graph's rows are tiled over at
    most ceil(N / 32) blocks (a block's 8 warps take 32 rows a round), in
    multiples of 4 (what a warp takes at a time); the tiles cover each row
    once."""
    p = fused_gnn.fwd_plan(b, n, d, f)
    assert p["whole"]
    if b >= 132:
        assert p["row_tiles"] == 1 and p["rows"] == n
        assert p["blocks"] == -(-b // p["graphs"]) >= 132
        assert p["graphs"] == 1 or p["graphs"] * n * max(n, f) <= 2048
    else:
        assert p["graphs"] == 1 and p["blocks"] == b * p["row_tiles"]
        assert p["rows"] == n or p["rows"] % 4 == 0
        assert p["row_tiles"] <= -(-n // 32)
        assert (p["row_tiles"] - 1) * p["rows"] < n <= p["row_tiles"] * p["rows"]


def test_forward_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="no plan"):
        fused_gnn.fwd_plan(2, 5, fused_gnn.MAX_FEAT + 1, 7)
    with pytest.raises(ValueError, match="no plan"):
        fused_gnn.fwd_plan(0, 5, 3, 7)
    with pytest.raises(ValueError, match="exceeds the grid limit"):
        fused_gnn.fwd_plan(1, 8 * 65535 + 1, 1, 1)
    assert not fused_gnn.fwd_plan(1, 8 * 65535, 1, 1)["whole"]


@pytest.mark.cuda
@pytest.mark.parametrize("d,f", [(16, 16), (128, 128)])
@pytest.mark.parametrize("b", [2, 132])
@pytest.mark.parametrize("side", [0, 1])
def test_cuda_forward_each_side_of_its_threshold(d, f, b, side):
    """On the card the forward launches its plan (whole graphs up to the
    threshold in N, the row-tile stream beyond), reports one launch, and
    agrees with the plain version; here it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the kernels run only on an NVIDIA GPU")
    n = _fwd_threshold(d, f) + side
    h, x, mask = (torch.from_numpy(a).cuda()
                  for a in _fused_inputs(b, n, d, f, seed=n))
    h = h * d ** -0.25
    before = fused_dot_graph_spmm.launches
    got = fused_dot_graph_spmm(h, x, mask)
    torch.cuda.synchronize()
    assert fused_dot_graph_spmm.launches == before + 1
    assert fused_dot_graph_spmm.kernel_fwd_plan(b, n, d, f) == \
        fused_gnn.fwd_plan(b, n, d, f)
    assert fused_gnn.fwd_plan(b, n, d, f)["whole"] == (side == 0)
    want = fused_dot_graph_spmm_plain(h, x, mask)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("eps", [1e-8, 1e-12])
def test_cosine_graph_matches_jax(eps):
    """Each norm clamped at eps (a zero row gives zeros, not nan)."""
    x = np.random.default_rng(20).normal(size=(3, 14, 60)).astype(np.float32)
    x[1, 4] = 0.0
    got = graphs.cosine_graph(torch.from_numpy(x), eps=eps)
    want = jgraphs.cosine_graph(jnp.asarray(x), eps=eps)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-5)


def test_pairwise_sq_dists_matches_jax_and_clips_at_zero():
    x = np.random.default_rng(21).normal(size=(4, 14, 50)).astype(np.float32)
    x[0, 3] = x[0, 5]  # a pair at distance 0: the expansion rounds near 0
    got = graphs.pairwise_sq_dists(torch.from_numpy(x))
    want = jgraphs.pairwise_sq_dists(jnp.asarray(x))
    assert (got >= 0).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("k", [1, 10, 14])
def test_topk_mask_matches_jax(k):
    s = np.random.default_rng(22).uniform(size=(5, 14, 14)).astype(
        np.float32)
    got = graphs.topk_mask(torch.from_numpy(s), k)
    np.testing.assert_array_equal(_np(got), _np(jgraphs.topk_mask(
        jnp.asarray(s), k)))
    assert (_np(got).sum(axis=-1) == k).all()  # distinct scores: k a row


def test_topk_mask_keeps_every_entry_tied_with_the_kth():
    """Ties at the threshold keep every tied entry, in both packages: a
    row of 0 scores (STGNN's underflowed similarities) keeps all 14."""
    s = np.zeros((2, 14, 14), np.float32)
    s[0, :, :3] = 1.0
    s[0, :, 3:6] = 0.5    # k = 4: three at 1.0, then three tied at 0.5
    got = _np(graphs.topk_mask(torch.from_numpy(s), 4))
    np.testing.assert_array_equal(got, _np(jgraphs.topk_mask(
        jnp.asarray(s), 4)))
    assert (got[0].sum(axis=-1) == 6).all() and (got[1] == 1).all()


def test_top_indices_tie_order_matches_jax_lax_top_k():
    """On tied scores the port's selection (SAGPool's) returns the lower
    index first, as jax.lax.top_k does, so both packages keep the same
    nodes; torch.topk keeps the same values but, on the CPU, other indices
    among ties (ROADMAP.md, Queue 3)."""
    rng = np.random.default_rng(23)
    s = rng.integers(0, 3, size=(50, 14)).astype(np.float32)  # many ties
    for k in (1, 5, 10, 14):
        got = graphs.top_indices(torch.from_numpy(s), k)
        want_v, want_i = jax.lax.top_k(jnp.asarray(s), k)
        np.testing.assert_array_equal(_np(got), _np(want_i))
        np.testing.assert_array_equal(
            _np(torch.topk(torch.from_numpy(s), k, dim=1).values),
            _np(want_v))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_chebyshev_terms_match_jax(k):
    rng = np.random.default_rng(24)
    adj = rng.uniform(size=(3, 14, 14)).astype(np.float32) / 14
    x = rng.normal(size=(3, 14, 8)).astype(np.float32)
    got = message_passing.chebyshev_terms(torch.from_numpy(adj),
                                          torch.from_numpy(x), k)
    want = jmp.chebyshev_terms(jnp.asarray(adj), jnp.asarray(x), k)
    assert len(got) == len(want) == k
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-6, rtol=1e-5)


def test_chebnet_matches_jax_and_draws_xavier_over_k_in_out():
    """ChebNet on the same filters, and its init bound: xavier_uniform_ on
    (K, in, out) takes fan_in = in*out and fan_out = K*out, as the JAX
    _xavier_uniform_3d does."""
    from gnn_rul_tpu.nn.gnn_blocks import ChebNet as JaxChebNet
    from gnn_rul_tpu_torch.nn.gnn_blocks import ChebNet

    rng = np.random.default_rng(25)
    adj = rng.uniform(size=(2, 14, 14)).astype(np.float32) / 14
    x = rng.normal(size=(2, 14, 50)).astype(np.float32)
    jnet = JaxChebNet(64, 3)
    jvars = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(adj))
    net = ChebNet(50, 64, 3)
    bound = np.sqrt(6.0 / (50 * 64 + 3 * 64))
    filters = _np(net.filters)
    assert filters.shape == (3, 50, 64) and np.abs(filters).max() <= bound
    assert np.abs(filters).max() > 0.95 * bound
    assert np.abs(np.asarray(jvars["params"]["filters"])).max() <= bound
    with torch.no_grad():
        net.filters.copy_(torch.tensor(np.asarray(jvars["params"]["filters"])))
        got = net(torch.from_numpy(x), torch.from_numpy(adj))
    want = jnet.apply(jvars, jnp.asarray(x), jnp.asarray(adj))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_dot_graph_matches_jax():
    """HierCorrPool's unparameterized graph of raw features at its FD001
    shape (B, 14, 80)."""
    x = np.random.default_rng(25).normal(size=(3, 14, 80)).astype(np.float32)
    got = graphs.dot_graph(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(jgraphs.dot_graph(
        jnp.asarray(x))), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("n", [14, 30])
def test_gaussian_graph_matches_jax_and_its_gradient_is_finite(n):
    """ASTGCNN's exp(-cdist) by direct differences, at 14 rows and above
    the 25 at which torch.cdist on CUDA would switch to the expansion; a
    repeated row gives a second distance of 0 off the diagonal. The
    gradient through the double-where root is finite, 0 at every zero
    distance, and equals JAX's."""
    rng = np.random.default_rng(26)
    x = rng.normal(size=(2, n, 50)).astype(np.float32) * 0.2
    x[1, 3] = x[1, 7]
    w = rng.normal(size=(2, n, n)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = graphs.gaussian_graph(xt)
    (got * torch.from_numpy(w)).sum().backward()
    want, vjp = jax.vjp(jgraphs.gaussian_graph, jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(w))
    assert np.all(np.diagonal(_np(got), axis1=-2, axis2=-1) == 1.0)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-5)
    assert torch.isfinite(xt.grad).all()
    np.testing.assert_allclose(_np(xt.grad), _np(want_grad), atol=1e-5,
                               rtol=1e-4)
    # A row's distance to itself is 0 wherever the row moves, so with
    # weight on the diagonal alone the gradient is exactly 0 (sqrt's own
    # derivative there would give nan).
    diag = torch.from_numpy(x).requires_grad_(True)
    graphs.gaussian_graph(diag).diagonal(dim1=-2, dim2=-1).sum().backward()
    want_diag = jax.grad(lambda v: jnp.sum(jnp.diagonal(
        jgraphs.gaussian_graph(v), axis1=-2, axis2=-1)))(jnp.asarray(x))
    assert torch.count_nonzero(diag.grad) == 0
    np.testing.assert_array_equal(_np(want_diag), 0.0)


def test_gaussian_topk_graph_matches_jax():
    x = np.random.default_rng(27).normal(size=(3, 14, 5)).astype(np.float32)
    got = graphs.gaussian_topk_graph(torch.from_numpy(x), 4)
    want = jgraphs.gaussian_topk_graph(jnp.asarray(x), 4)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-5)
    assert (_np(got > 0).sum(axis=-1) == 4).all()


@pytest.mark.parametrize("weight,eps", [(1.0, 0.0), (0.5, 1e-3)])
def test_self_loops_and_sym_normalize_match_jax(weight, eps):
    adj = np.random.default_rng(28).uniform(size=(3, 14, 14)).astype(
        np.float32)
    adj[0, 2] = 0.0  # a row of degree 0 before the loops
    got = graphs.add_self_loops(torch.from_numpy(adj), weight)
    want = jgraphs.add_self_loops(jnp.asarray(adj), weight)
    np.testing.assert_array_equal(_np(got), _np(want))
    for a in (adj, _np(got)):
        np.testing.assert_allclose(
            _np(graphs.sym_normalize(torch.from_numpy(a), eps)),
            _np(jgraphs.sym_normalize(jnp.asarray(a), eps)), atol=1e-6,
            rtol=1e-5)
