"""The keyed dropout operator (``ops/kernels/keyed_dropout.py``) on the
CPU: its plain version is the keyed mask of ``keep_mask`` and flax's
``where(keep, x / (1 - p), 0)``; grouped keys, the vmap rule and the
gradient give each seed its own call's result. The CUDA kernel is held
against this plain version on the card by chip_smoke.py."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu_torch.nn.basic import Dropout, dropout_key, step_key
from gnn_rul_tpu_torch.ops.kernels import keyed_dropout as kd

torch.set_num_threads(1)


def _x(shape, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("p", [0.1, 0.2, 0.5])
def test_plain_version_is_the_keyed_mask_and_flax_scale(p):
    """Element e of call n under key k is kept where keep_mask of
    mix(k + n * golden) keeps it, and then equals jnp's x / (1 - p) bit
    for bit (flax's Dropout at the same mask), else 0."""
    x = _x((100, 2, 14, 16))
    key = torch.tensor(step_key(3, 2, 7))
    out = kd.keyed_dropout(x, key, 1, p)
    keep = kd.keep_mask(kd.call_key(key, 1), x.shape, p, x.device)
    assert torch.equal(out != 0, keep)
    want = jnp.where(jnp.asarray(keep.numpy()), jnp.asarray(x.numpy())
                     / (1.0 - p), 0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert abs(keep.double().mean().item() - (1 - p)) < 0.01


def test_dropout_module_draws_the_operators_calls_in_order():
    """Dropout's n-th call inside one key is the operator's call n."""
    drop = Dropout(0.3).train()
    x = _x((50, 40), 1)
    key = step_key(0, 1, 4)
    with dropout_key(key):
        first, second = drop(x), drop(x)
    k = torch.tensor(key)
    assert torch.equal(first, kd.keyed_dropout_plain(x, k, 0, 0.3))
    assert torch.equal(second, kd.keyed_dropout_plain(x, k, 1, 0.3))
    assert not torch.equal(first, second)


def test_grouped_keys_and_vmap_give_each_seed_its_own_call():
    """(G,) keys: group g's slice as a call of its own on key[g]; under
    vmap with one key a seed (x mapped or shared), and with a key shared
    by every seed, each seed's result is its own call's."""
    keys = torch.tensor([step_key(s, 1, 0) for s in range(5)])
    x = _x((5 * 30, 7), 2)
    grouped = kd.keyed_dropout(x, keys, 2, 0.2)
    one = [kd.keyed_dropout_plain(x[30 * g:30 * (g + 1)], keys[g], 2, 0.2)
           for g in range(5)]
    assert torch.equal(grouped, torch.cat(one))

    xs = x.reshape(5, 30, 7)
    fn = torch.func.vmap(lambda v, k: kd.keyed_dropout(v, k, 2, 0.2),
                         randomness="error")
    assert torch.equal(fn(xs, keys), torch.stack(one))
    shared = torch.func.vmap(lambda k: kd.keyed_dropout(xs[0], k, 2, 0.2),
                             randomness="error")(keys)
    assert torch.equal(shared[3], kd.keyed_dropout_plain(xs[0], keys[3], 2,
                                                         0.2))
    same = torch.func.vmap(lambda v: kd.keyed_dropout(v, keys[1], 2, 0.2),
                           randomness="error")(xs)
    for s in range(5):
        assert torch.equal(same[s],
                           kd.keyed_dropout_plain(xs[s], keys[1], 2, 0.2))


def test_gradient_is_the_same_mask_and_scale():
    """The operator's gradient is the operator on the incoming gradient:
    what autograd gives through where(keep, x / (1 - p), 0), under vmap
    too."""
    x = _x((64, 9), 3).requires_grad_(True)
    g = _x((64, 9), 4)
    key = torch.tensor(step_key(1, 1, 1))
    kd.keyed_dropout(x, key, 0, 0.25).backward(g)
    keep = kd.keep_mask(kd.call_key(key, 0), x.shape, 0.25, x.device)
    ref = x.detach().clone().requires_grad_(True)
    torch.where(keep, ref / 0.75, torch.zeros_like(ref)).backward(g)
    assert torch.equal(x.grad, ref.grad)

    keys = torch.tensor([step_key(s, 1, 1) for s in range(3)])
    xs = _x((3, 64, 9), 5).requires_grad_(True)
    out = torch.func.vmap(lambda v, k: kd.keyed_dropout(v, k, 0, 0.25),
                          randomness="error")(xs, keys)
    out.backward(torch.ones_like(out))
    for s in range(3):
        m = kd.keep_mask(kd.call_key(keys[s], 0), (64, 9), 0.25, xs.device)
        assert torch.equal(xs.grad[s], torch.where(m, 1 / torch.tensor(
            0.75), torch.tensor(0.0)).expand(64, 9))


def test_bf16_is_divided_in_fp32_and_rounded_once():
    x = _x((40, 33), 6).to(torch.bfloat16)
    key = torch.tensor(step_key(2, 1, 0))
    out = kd.keyed_dropout(x, key, 0, 0.2)
    keep = kd.keep_mask(kd.call_key(key, 0), x.shape, 0.2, x.device)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, torch.where(keep, x.float() / 0.8,
                                        torch.tensor(0.0)).to(torch.bfloat16))


@pytest.mark.parametrize("x, key, p, match", [
    (_x((10, 4)).double(), torch.tensor(5), 0.1, "float32 or bfloat16"),
    (_x((10, 4)), torch.tensor(5, dtype=torch.int32), 0.1, "int64"),
    (_x((10, 4)), torch.zeros(7, dtype=torch.int64), 0.1, "divide"),
    (_x((10, 4)), torch.tensor(5), 1.0, r"\[0, 1\)"),
])
def test_operator_refuses_what_the_kernel_does_not_take(x, key, p, match):
    with pytest.raises((TypeError, ValueError), match=match):
        kd.keyed_dropout(x, key, 0, p)


def test_fake_gives_the_input_shape_and_dtype():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        x = torch.empty(100, 2, 14, 16)
        out = kd.keyed_dropout(x, torch.tensor(3), 0, 0.1)
    assert out.shape == (100, 2, 14, 16) and out.dtype == torch.float32


@pytest.mark.cuda
def test_kernel_is_the_plain_version_bit_for_bit_on_the_card():
    """On the card the kernel gives the CPU plain version's bits (both
    divide), one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = _x((2500, 14, 14), 7)
    key = torch.tensor([step_key(s, 1, 0) for s in range(5)])
    before = kd.keyed_dropout.launches
    got = kd.keyed_dropout(x.cuda(), key.cuda(), 3, 0.2)
    assert kd.keyed_dropout.launches == before + 1
    assert torch.equal(got.cpu(), kd.keyed_dropout_plain(x, key, 3, 0.2))
