"""The port's DVGTformer (gnn_rul_tpu_torch.models.dvgtformer) against the
JAX package's on the CPU: at CMAPSS/FD001 full width the eval forward, the
weight round trip, 5 Adam steps and the symbolic-batch artifact; the
forward at N-CMAPSS's tier-4 width (20 sensors); the positional encoding's
quirk, the attention block and the exact GELU on their own.

The port's LayerNorms keep torch's epsilon (1e-5, the reference's), the
JAX package's flax's (1e-6): ROADMAP.md Queue 3 entry 7. The forward is
held against the JAX package as it is. The 5-step trajectory is held
against it with its LayerNorm patched to 1e-5 (both packages then compute
one function): on the JAX package's own epsilon the first step's loss is
already 2.2e-4 apart, and five steps of this unsteady trajectory (the loss
goes 2.7, 4.0, 6.2, 2.3, 1.6) take it to 1.5e-2."""

import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu.models.dvgtformer import (VGTBlock as JaxVGTBlock,
                                           _dvgt_positional_encoding)
from gnn_rul_tpu_torch.configs.hparams import model_hparams
from gnn_rul_tpu_torch.models.dvgtformer import (DVGTformer, VGTBlock,
                                                 positional_encoding)
from gnn_rul_tpu_torch.nn.basic import GELU
from gnn_rul_tpu_torch.train import algorithms

import test_torch_model_checks as checks

METHOD = "DVGTformer"


@pytest.fixture(scope="module")
def variables():
    return checks.jax_variables(METHOD)


def _torch_layernorm_epsilon(monkeypatch):
    """The JAX package's LayerNorms at torch's epsilon, 1e-5."""
    monkeypatch.setattr(flax.linen, "LayerNorm", functools.partial(
        flax.linen.LayerNorm, epsilon=1e-5))


@pytest.mark.parametrize("rows", [4, 10])
def test_eval_output_matches_jax(variables, rows):
    """Against the JAX package's own LayerNorm epsilon (1e-6): the gap is
    1.5e-4 at 4 rows and 1.9e-4 at 10, inside the tolerance."""
    assert checks.check_eval_forward(METHOD, variables, rows,
                                     seed=rows) == 0


def test_eval_output_at_one_epsilon_is_much_closer(variables, monkeypatch):
    """With the JAX LayerNorm at 1e-5 the two forwards agree to 1e-5 (1.6e-6
    measured at 10 rows): the gap above is the epsilon's."""
    _torch_layernorm_epsilon(monkeypatch)
    x = checks.x_rows(10, seed=10)
    want = np.asarray(checks.jax_model(METHOD).apply(
        variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = checks.port_model(METHOD, variables).eval()(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_weight_carry_round_trips_exactly(variables):
    checks.check_round_trip(METHOD, variables)


def test_five_adam_steps_match_jax(monkeypatch):
    """Dropout (0.1, the temporal blocks') off on both sides, the JAX
    LayerNorm at 1e-5 (module docstring). The losses hold against JAX
    (3.8e-5 apart); so do the parameters (3.3e-4), though one weight of
    svgt1's ff1 has a first-step gradient that cancels its weight decay to
    1e-8, below fp32's rounding of it, so Adam's first step there moves it
    by a share of the learning rate that rounding decides: the port ends
    1.2e-3 and JAX's fp32 run 8.7e-4 from the same steps in fp64."""
    _torch_layernorm_epsilon(monkeypatch)
    assert checks.check_trajectory(METHOD, monkeypatch) == ("jax", "jax", 0.0)


def test_symbolic_artifact_matches_live_model(variables, tmp_path):
    """The positional encoding (a buffer) and the virtual node and step
    (t_v, x_v expanded to the batch) trace at a symbolic batch; no port
    kernel in the program."""
    program = checks.check_symbolic_artifact(METHOD, variables, tmp_path)
    assert checks.our_op_nodes(program) == 0


def test_ncmapss_forward_matches_jax():
    """Tier 4 (BASELINE.md): N-CMAPSS's 20 sensors, so tokens of 21
    features in the temporal blocks and a positional encoding of (51, 21),
    against the JAX package's own LayerNorm epsilon."""
    assert model_hparams("NCMAPSS", None, METHOD)["num_nodes"] == 20
    checks.check_cell_forward(METHOD, "NCMAPSS", None, rows=4, seed=6)


@pytest.mark.parametrize("n,d", [(51, 15), (51, 21), (15, 51), (4, 6)])
def test_positional_encoding_quirk(n, d):
    """The reference's loop: exponent 2i/d over the raw even index, so the
    columns do not follow the usual 10000^(i/d); at odd d the last column
    stays 0. The model holds it as a buffer outside the state_dict."""
    pe = positional_encoding(n, d)
    np.testing.assert_array_equal(pe, _dvgt_positional_encoding(n, d))
    np.testing.assert_array_equal(pe[:, 0], np.sin(np.arange(n)))
    np.testing.assert_allclose(pe[:, 2], np.sin(np.arange(n) / 10000 ** (
        4 / d)), rtol=1e-12)
    assert np.all(pe[:, -1] == 0) == (d % 2 == 1)
    if (n, d) == (51, 15):
        model = DVGTformer(**model_hparams("CMAPSS", "FD001", METHOD))
        torch.testing.assert_close(model.pe, torch.tensor(pe,
                                                          dtype=torch.float32))
        assert "pe" not in model.state_dict()


@pytest.mark.parametrize("apply_dropout", [True, False])
def test_vgt_block_matches_jax(apply_dropout):
    """One block alone, eval mode, on seeded tokens and prior: the stacked
    heads, the prior's softmax(relu), the second softmax over the mix, the
    post-LN residuals, at the JAX package's epsilon patched to torch's."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 9, 7)).astype(np.float32)
    prior = rng.uniform(-1, 1, size=(3, 9, 9)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        _torch_layernorm_epsilon(mp)
        jblock = JaxVGTBlock(7, 12, 3, 0.5, 10, 0.1, apply_dropout)
        jvars = checks.numpy_tree(dict(jblock.init(
            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(prior))))
        want = np.asarray(jblock.apply(jvars, jnp.asarray(x),
                                       jnp.asarray(prior)))
    tag = "temp" if apply_dropout else "spat"
    block = VGTBlock(tag, 7, 12, 3, 0.5, 10, 0.1, apply_dropout).eval()
    p = jvars["params"]
    sd = {}
    for name, (prefix, leaf) in {
            **{f"{q}{h}": (f"linears_{q.upper()}_{tag}.{h}", "Dense_0")
               for q in "qkv" for h in range(3)},
            "W_O": (f"W_O_{tag}", "Dense_0"),
            "ff0": (f"feed_forward_{tag}.0", "Dense_0"),
            "ff1": (f"feed_forward_{tag}.2", "Dense_0"),
            "layer_norm1": (f"layer_norm1_{tag}", None),
            "layer_norm2": (f"layer_norm2_{tag}", None)}.items():
        leaves = p[name][leaf] if leaf else p[name]
        w = leaves["kernel"].T if leaf else leaves["scale"]
        sd[f"{prefix}.weight"] = torch.tensor(np.ascontiguousarray(w))
        sd[f"{prefix}.bias"] = torch.tensor(leaves["bias"])
    block.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x), torch.from_numpy(prior)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (block.dropout is not None) == apply_dropout


def test_gelu_keeps_the_tail_jax_keeps():
    """nn.basic.GELU against jax.nn.gelu(approximate=False), value and
    gradient, across the negative tail where torch.nn.GELU's 1 + erf
    cancels in fp32 (0 from x = -5.5, where the value is -5.9e-9 at -6)."""
    x = np.linspace(-12, 4, 161).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = GELU()(xt)
    y.sum().backward()
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    want_grad = np.asarray(jax.grad(lambda v: jnp.sum(jax.nn.gelu(
        v, approximate=False)))(jnp.asarray(x)))
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-5,
                               atol=1e-30)
    np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=1e-4,
                               atol=1e-30)
    tail = torch.tensor([-6.0])
    assert torch.nn.functional.gelu(tail).item() == 0.0
    assert GELU()(tail).item() == pytest.approx(-5.9195e-9, rel=1e-4)


def test_build_model_and_spec_resolve():
    spec = algorithms.get_algorithm_spec(METHOD)
    assert spec.model_cls is DVGTformer and spec.aux_weight is None
    model = checks.port_model(METHOD, checks.jax_variables(METHOD, seed=3))
    assert sorted({k.split(".")[0] for k in model.state_dict()}) == [
        "linear_t", "linear_x", "output_layer", "svgtformer_blocks",
        "t_v", "tvgtformer_blocks", "x_v"]
    assert sum(isinstance(m, torch.nn.Dropout) for m in model.modules()) == 3
