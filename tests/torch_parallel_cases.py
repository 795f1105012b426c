"""The cases of tests/test_torch_parallel.py that run over the model axis:
one rank of a job of 2 or 4 ranks on the CPU (the ``GNNRUL_*`` variables
set by ``gnn_rul_tpu_torch.parallel._dist_worker.launch``)::

    python tests/torch_parallel_cases.py OUTDIR

Rank 0 writes ``OUTDIR/cases.pt``: each node-sharded engine's output and
its inputs' gradients under a seeded cotangent, on the mesh ``data=1,
model=k`` of the job's k ranks; at 2 ranks, the 7 hooked methods' forwards
with and without the hook and one training step of each through it; at 4
ranks, FC_STGNN's step on ``data=2, model=2``. The test module builds the
same inputs with :func:`inputs`, so this file imports torch and the port
alone.
"""

import functools
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gnn_rul_tpu_torch.parallel import graph_partition as gp  # noqa: E402

HOOKED = ("FC_STGNN", "LOGO", "HierCorrPool", "STFA", "LOGO_bearing",
          "HierCorrPool_bearing", "GAT_LSTM")
# The engines' cases: (name, engine, ranks, input shapes), the JAX tests'
# (tests/test_parallel.py, tests/test_graph_sharded_models.py) at 2 and 4
# ranks.
CASES = (
    [(f"spmm n{n} k{k}", "spmm", k, {"adj": (6, n, n), "x": (6, n, 5)})
     for n, k in ((16, 4), (14, 4), (13, 2), (16, 2))]
    + [("spmm unbatched k4", "spmm", 4, {"adj": (10, 10), "x": (3, 10, 4)}),
       ("spmm unbatched k2", "spmm", 2, {"adj": (10, 10), "x": (3, 10, 4)})]
    + [(f"gat n{n} k{k}", "gat", k, {"wh": (5, n, 7), "f1": (5, n),
                                      "f2": (5, n), "adj": (n, n)})
       for n in (16, 30) for k in (2, 4)]
    + [(f"dot graph k{k}", "dot_graph", k, {"x": (4, 16, 8), "v": (4, 16, 8)})
       for k in (2, 4)]
    + [(f"dot graph masked k{k}", "dot_graph", k,
        {"x": (3, 16, 6), "v": (3, 16, 5), "mask": (16, 16)})
       for k in (2, 4)]
    + [(f"ring k{k}", "ring", k, {"x": (4, 16, 8), "v": (4, 16, 6)})
       for k in (2, 4)]
    + [(f"ring masked k{k}", "ring", k,
        {"x": (3, 16, 6), "v": (3, 16, 5), "mask": (16, 16)})
       for k in (2, 4)]
    + [("ring wide k4", "ring", 4, {"x": (2, 32, 8), "v": (2, 32, 8)})])
GAT_BIAS, GAT_SLOPE = 0.3, 0.1


def inputs(name, shapes):
    """Seeded float32 inputs of a case, and the cotangent of its output:
    normal values, a 0/1 adjacency for the attention, uniform masks."""
    rng = np.random.default_rng(sum(map(ord, name)))
    out = {}
    for key, shape in shapes.items():
        if key == "mask":
            out[key] = rng.uniform(size=shape)
        elif key == "adj" and "gat" in name:
            out[key] = (rng.uniform(size=shape) > 0.5).astype(np.float64)
        else:
            out[key] = rng.normal(size=shape)
    out = {k: torch.from_numpy(v.astype(np.float32)) for k, v in out.items()}
    rows = shapes.get("wh", shapes.get("x"))
    cols = shapes.get("wh", shapes.get("v", shapes.get("x")))
    out["cot"] = torch.from_numpy(
        rng.normal(size=(*rows[:-1], cols[-1])).astype(np.float32))
    return out


def local(engine, t):
    """The local computation of an engine's case."""
    if engine == "spmm":
        adj = t["adj"]
        return torch.einsum("bnm,bmd->bnd", adj.expand(t["x"].shape[0],
                                                       *adj.shape[-2:]),
                            t["x"])
    if engine == "gat":
        e = torch.nn.functional.leaky_relu(
            t["f1"][:, :, None] + t["f2"][:, None, :] + GAT_BIAS, GAT_SLOPE)
        return torch.einsum("bnm,bmd->bnd", torch.softmax(e, -1) * t["adj"],
                            t["wh"])
    x, v = t["x"], t["v"]
    eye = torch.eye(x.shape[1])
    s = torch.nn.functional.leaky_relu(x @ x.transpose(1, 2) - eye * 1e8,
                                       0.01)
    a = torch.softmax(s, -1) + eye
    if "mask" in t:
        a = a * t["mask"]
    return a @ v


def sharded(engine, t, mesh):
    if engine == "spmm":
        return gp.node_sharded_spmm(t["adj"], t["x"], mesh)
    if engine == "gat":
        return gp.node_sharded_gat(t["wh"], t["f1"], t["f2"], t["adj"],
                                   GAT_BIAS, GAT_SLOPE, mesh)
    fn = (gp.node_sharded_dot_graph_spmm if engine == "dot_graph"
          else gp.ring_dot_graph_spmm)
    return fn(t["x"], t["v"], mesh, mask=t.get("mask"))


def with_grads(fn, t):
    """``fn``'s output and the gradients of ``sum(out * cot)`` with respect
    to each input but the mask and the cotangent."""
    leaves = {k: v.clone().requires_grad_(k not in ("mask", "cot"))
              for k, v in t.items()}
    out = fn(leaves)
    (out * leaves["cot"]).sum().backward()
    return out.detach(), {k: v.grad for k, v in leaves.items()
                          if v.grad is not None}


def hooked_step(method, mesh=None):
    """One training step of ``torch_mesh_cases``'s first batch, dropout off
    (the hooked attention's mask is another stream), through the hook over
    ``mesh`` (none without one), the wide parameters split over its model
    axis (HierCorrPool's, STFA's, HierCorrPool_bearing's and GAT_LSTM's);
    the loss and the gradients, gathered whole."""
    import torch_mesh_cases as cases
    from gnn_rul_tpu_torch.parallel.model_axis import whole_grads
    hook = gp.spmm_hook_kwargs(method, mesh) if mesh is not None else {}
    engine = cases.engine(method, mesh, **hook)
    no_dropout(engine.model)
    x, y = cases.batches(method)[0]
    loss = engine.train_step(x, y)
    return float(loss), whole_grads(engine.model)


def hooked_models(mesh):
    """Each hooked method at the bank's widths: the eval forward on 4 rows
    without and with its hook, from the same weights, and
    :func:`hooked_step`."""
    import torch_mesh_cases as cases
    out = {}
    for method in HOOKED:
        base = cases.engine(method).model.float().eval()
        hooked = cases.engine(method, **gp.spmm_hook_kwargs(
            method, mesh)).model.float().eval()
        x = torch.from_numpy(cases.x_rows(4, 0, method))
        with torch.no_grad():
            out[method] = {"local": base(x), "hooked": hooked(x)}
        out[method]["step"] = hooked_step(method, mesh)
    return out


def gat_dropout(mesh, p=0.5):
    """The hooked attention panel with a Dropout of ``p`` in train mode,
    twice under one key, and without dropout."""
    from gnn_rul_tpu_torch.nn.basic import Dropout, dropout_key
    t = inputs("gat dropout", {"wh": (3, 8, 4), "f1": (3, 8), "f2": (3, 8),
                               "adj": (8, 8)})
    t["adj"] = torch.ones(8, 8)
    drop = Dropout(p).train()
    outs = []
    for _ in range(2):
        with dropout_key(7):
            outs.append(gp.node_sharded_gat(t["wh"], t["f1"], t["f2"],
                                            t["adj"], 0.0, 0.1, mesh,
                                            dropout=drop))
    return outs + [gp.node_sharded_gat(t["wh"], t["f1"], t["f2"], t["adj"],
                                       0.0, 0.1, mesh)]


def no_dropout(model):
    """Every dropout of ``model`` off (p = 0)."""
    for mod in model.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    return model


def main(outdir):
    import torch.distributed as dist
    import torch_mesh_cases as cases
    from gnn_rul_tpu_torch.parallel.mesh import make_mesh
    torch.set_num_threads(1)
    cases.lift_fp32_checks()
    k = int(os.environ["GNNRUL_NUM_PROCESSES"])
    mesh = make_mesh(1, k, device="cpu")
    results = {}
    for name, engine, ranks, shapes in CASES:
        if ranks == k:
            results[name] = with_grads(
                functools.partial(sharded, engine, mesh=mesh),
                inputs(name, shapes))
    if k == 2:
        results["models"] = hooked_models(mesh)
        results["gat dropout"] = gat_dropout(mesh)
    if k == 4:
        # FC_STGNN's two steps of torch_mesh_cases.run through the hook on
        # data=2, model=2.
        dm = make_mesh(2, 2, device="cpu")
        results["data=2,model=2"] = cases.run(
            "FC_STGNN", dm, **gp.spmm_hook_kwargs("FC_STGNN", dm))
    if dist.get_rank() == 0:
        torch.save(results, os.path.join(outdir, "cases.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
