"""The node-sharded graph engines (``gnn_rul_tpu_torch/parallel/
graph_partition.py``) on the CPU, against the JAX package's.

Two gloo jobs, of 2 and of 4 ranks (``tests/torch_parallel_cases.py``, each
run once for the module), compute every engine on the mesh ``data=1,
model=k``: node_sharded_spmm at the JAX tests' (16, 4), (14, 4) and (13, 2)
(padded) and an unbatched adjacency, node_sharded_gat at (16, 4) and (30,
4) (padded rows and columns), node_sharded_dot_graph_spmm and
ring_dot_graph_spmm with and without FC_STGNN's mask, each at 2 and 4
ranks too. Each output is held against JAX's local computation (one
case an engine, JAX_SHARDED, against the JAX package's own engine on its
8-device CPU mesh, tests/conftest.py, too) and each input's gradient
against the local computation's,
the ring's at 4 ranks against ``jax.grad`` too, at the JAX tests' atol and
rtol of 1e-5. At 2 ranks the 7 hooked methods' forwards under the hook
equal their forwards without it (tests/test_graph_sharded_models.py's 2e-4)
and one training step through the hook equals the step without it; at 4
ranks FC_STGNN trains on ``data=2, model=2`` to the single process's
steps."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as steps
import torch_parallel_cases as cases
from gnn_rul_tpu.ops.graphs import dot_graph as jax_dot_graph
from gnn_rul_tpu.ops.message_passing import spmm as jax_spmm
from gnn_rul_tpu.ops.pallas.fused_gnn import fused_dot_graph_spmm_reference
from gnn_rul_tpu.parallel import graph_partition as jgp
from gnn_rul_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gnn_rul_tpu.train.algorithms import (get_algorithm_spec as jax_spec,
                                          registered_algorithms)
from gnn_rul_tpu_torch.models import MODELS
from gnn_rul_tpu_torch.parallel._dist_worker import launch
from gnn_rul_tpu_torch.parallel.graph_partition import spmm_hook_kwargs
from gnn_rul_tpu_torch.train.algorithms import get_algorithm_spec

torch.set_num_threads(1)

ATOL = RTOL = 1e-5                      # tests/test_parallel.py
MODEL_ATOL = MODEL_RTOL = 2e-4          # tests/test_graph_sharded_models.py
LOSS_RTOL, LOSS_ATOL, PARAM_MAX_DIFF = 2e-4, 2e-5, 5e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
JOB_TIMEOUT = 240
# The cases held against JAX's own sharded engine too (each compiles a
# shard_map, the ring's some seconds): one an engine, at 2 ranks, padded or
# masked where the engine allows it. Every case is held against JAX's local
# computation.
JAX_SHARDED = ("spmm n13 k2", "gat n30 k2", "dot graph masked k2",
               "ring masked k2")


def _job(out, ranks):
    launch([cases.__file__, str(out)], ranks, JOB_TIMEOUT)
    return torch.load(os.path.join(out, "cases.pt"), weights_only=False)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    # The directories before the threads: the factory's first call in a
    # process empties its base directory, so two first calls at once race.
    outs = {k: tmp_path_factory.mktemp(f"graph_partition_{k}")
            for k in (2, 4)}
    with ThreadPoolExecutor(2) as pool:   # the two jobs at once
        done = {k: pool.submit(_job, outs[k], k) for k in (2, 4)}
        return {k: f.result() for k, f in done.items()}


def _jax(a):
    return jnp.asarray(a.numpy())


def _jax_sharded(engine, t, k):
    mesh = jax_make_mesh(n_data=1, n_model=k)
    if engine == "spmm":
        return jgp.node_sharded_spmm(_jax(t["adj"]), _jax(t["x"]), mesh,
                                     axis="model")
    if engine == "gat":
        return jgp.node_sharded_gat(
            _jax(t["wh"]), _jax(t["f1"]), _jax(t["f2"]), _jax(t["adj"]),
            cases.GAT_BIAS, cases.GAT_SLOPE, mesh, axis="model")
    fn = (jgp.node_sharded_dot_graph_spmm if engine == "dot_graph"
          else jgp.ring_dot_graph_spmm)
    mask = _jax(t["mask"]) if "mask" in t else None
    return fn(_jax(t["x"]), _jax(t["v"]), mesh, axis="model", mask=mask)


def _jax_local(engine, t):
    if engine == "spmm":
        adj = jnp.broadcast_to(_jax(t["adj"]),
                               (t["x"].shape[0],) + tuple(t["adj"].shape[-2:]))
        return jnp.einsum("bnm,bmd->bnd", adj, _jax(t["x"]))
    if engine == "gat":
        e = jax.nn.leaky_relu(_jax(t["f1"])[:, :, None]
                              + _jax(t["f2"])[:, None, :] + cases.GAT_BIAS,
                              cases.GAT_SLOPE)
        return jnp.einsum("bnm,bmd->bnd",
                          jax.nn.softmax(e, -1) * _jax(t["adj"]),
                          _jax(t["wh"]))
    if "mask" in t:
        return fused_dot_graph_spmm_reference(_jax(t["x"]), _jax(t["v"]),
                                              _jax(t["mask"]))
    return jax_spmm(jax_dot_graph(_jax(t["x"])), _jax(t["v"]))


@pytest.mark.parametrize("name,engine,ranks,shapes", cases.CASES,
                         ids=[c[0] for c in cases.CASES])
def test_engine_equals_jax_and_the_local_computation(jobs, name, engine,
                                                     ranks, shapes):
    out, grads = jobs[ranks][name]
    t = cases.inputs(name, shapes)
    if name in JAX_SHARDED:
        np.testing.assert_allclose(out.numpy(), np.asarray(
            _jax_sharded(engine, t, ranks)), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(_jax_local(engine, t)),
                               atol=ATOL, rtol=RTOL)
    want_out, want = cases.with_grads(lambda l: cases.local(engine, l), t)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), atol=ATOL,
                               rtol=RTOL)
    assert grads.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(grads[k].numpy(), want[k].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=k)


def test_ring_gradient_at_four_ranks_equals_jax_grad(jobs):
    """tests/test_parallel.py::test_ring_graph_four_way_and_grad's check of
    the ring's backward, against ``jax.grad`` of the dense computation."""
    name = "ring wide k4"
    shapes = next(c[3] for c in cases.CASES if c[0] == name)
    t = cases.inputs(name, shapes)
    _, grads = jobs[4][name]

    def dense(x, v):
        return jnp.sum(jax_spmm(jax_dot_graph(x), v) * _jax(t["cot"]))

    gx, gv = jax.grad(dense, argnums=(0, 1))(_jax(t["x"]), _jax(t["v"]))
    np.testing.assert_allclose(grads["x"].numpy(), np.asarray(gx), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(grads["v"].numpy(), np.asarray(gv), atol=ATOL,
                               rtol=RTOL)


def test_hooked_attention_dropout_is_a_keyed_dropout(jobs):
    """Under one key the hooked panel's dropout draws the same mask twice,
    and the mask changes the answer (its stream is the rank's)."""
    first, second, base = jobs[2]["gat dropout"]
    assert torch.equal(first, second)
    assert not torch.allclose(first, base)


@pytest.mark.parametrize("method", cases.HOOKED)
def test_hooked_forward_equals_the_local_forward(jobs, method):
    got = jobs[2]["models"][method]
    np.testing.assert_allclose(got["hooked"].numpy(), got["local"].numpy(),
                               atol=MODEL_ATOL, rtol=MODEL_RTOL,
                               err_msg=f"{method} under the hook")


@pytest.mark.parametrize("method", cases.HOOKED)
def test_hooked_step_equals_the_local_step(jobs, method, monkeypatch):
    steps.lift_fp32_checks(monkeypatch.setattr)
    loss, grads = jobs[2]["models"][method]["step"]
    want_loss, want = cases.hooked_step(method)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    assert grads.keys() == want.keys()
    for k in want:
        excess = ((grads[k] - want[k]).abs()
                  - (GRAD_ATOL + GRAD_RTOL * want[k].abs())).max().item()
        assert excess <= 0, (method, k, excess)


def test_data_and_model_axes_together_equal_the_single_process(jobs):
    got, want = jobs[4]["data=2,model=2"], steps.run("FC_STGNN")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    diff = max((got["after"][k].double() - v.double()).abs().max().item()
               for k, v in want["after"].items() if v.is_floating_point())
    assert diff < PARAM_MAX_DIFF
    np.testing.assert_allclose(got["preds"], want["preds"], atol=1e-4,
                               rtol=0)


def test_spmm_hook_kwargs_covers_exactly_the_supported_methods():
    supported = {m for m in MODELS if get_algorithm_spec(m).supports_spmm_fn}
    assert supported == set(cases.HOOKED)
    assert supported == {m for m in registered_algorithms()
                         if jax_spec(m).supports_spmm_fn}
    jax_mesh = jax_make_mesh(n_data=1, n_model=2)
    for m in MODELS:
        if m not in supported:
            with pytest.raises(ValueError):
                spmm_hook_kwargs(m, None)
            continue
        assert spmm_hook_kwargs(m, None).keys() == \
            jgp.spmm_hook_kwargs(m, jax_mesh).keys()
