"""JAX-package variables -> the port's ``state_dict``.

The inverse of the JAX package's torch-reference import
(``gnn_rul_tpu/compat/torch_import.py``: ``_map_fc_stgnn``, ``_map_logo``,
``_map_hagcn``, ``_map_rgcnu``, ``_map_stagnn``, ``_map_stfa``,
``_map_gru_cm``, ``_map_stgnn``, ``_map_dvgtformer``,
``_hiercorrpool_core`` for HierCorrPool and HierCorrPool_bearing,
``_map_astgcnn``, ``_map_st_conv``, ``_map_st_gcn``, ``_map_sagcn``,
``_map_agcn_tf``, ``_map_stmsgcn``, ``_map_stnet``, ``_map_gat_lstm``,
``_map_gdagdl``, ``_logo_core`` for LOGO_bearing) for every method: it
takes the flax
``{"params", "batch_stats"}`` tree as numpy arrays and returns a
``state_dict`` under the original torch reference's keys, which the port's
modules carry:

  - Dense kernel ``(in, out)``   -> Linear weight ``(out, in)``   [transpose]
  - Conv kernel ``(k, in, out)`` -> Conv1d weight ``(out, in, k)``, or
    ``(kh, kw, in, out)`` -> Conv2d weight ``(out, in, kh, kw)``, and its
    ``bias`` where the flax tree has one
  - GAT ``att_kernel (2d, 1)``, ``att_bias (1,)`` -> the attention Linear's
    ``weight (1, 2d)``, ``bias (1,)``
  - BatchNorm ``scale/bias`` + ``mean/var`` -> ``weight/bias`` +
    ``running_mean/running_var``, with ``num_batches_tracked`` 0
  - LayerNorm ``scale/bias`` -> ``weight/bias``
  - LSTM ``w_ih (D, 4H)``, ``w_hh (H, 4H)``, ``b_ih``, ``b_hh`` ->
    ``weight_ih_l0 (4H, D)``, ``weight_hh_l0 (4H, H)``, ``bias_ih_l0``,
    ``bias_hh_l0`` (``_reverse`` for the backward direction); a GRU's
    ``(D, 3H)``, ``(H, 3H)`` alike
  - a raw parameter (GIN's ``eps``, ChebNet's ``filters``, ST_Conv's
    ``theta1``-``theta4``, DVGTformer's ``t_v``/``x_v``) as it is, or
    transposed (GRU_CM's ``edge_kernel (2f, out)`` -> the edge Linear's
    ``weight (out, 2f)``, ASTGCNN's bias-free ``distance_P`` kernel -> the
    ``P`` Linear's weight), under the row's whole key
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch


Layout = List[Tuple[str, str, Tuple[str, ...]]]


def _fc_stgnn_layout() -> Layout:
    """``(torch prefix, kind, flax path)`` for every FC_STGNN layer."""
    enc = ("nonlin_map",)
    rows = [
        ("nonlin_map.conv_block1.0", "conv", enc + ("conv1", "Conv_0")),
        ("nonlin_map.conv_block1.1", "bn",
         enc + ("bn1", "BatchNorm1d_0", "BatchNorm_0")),
        ("nonlin_map.conv_block2.0", "conv", enc + ("conv2", "Conv_0")),
        ("nonlin_map.conv_block2.1", "bn",
         enc + ("bn2", "BatchNorm1d_0", "BatchNorm_0")),
        ("nonlin_map2.0", "linear", ("nonlin_map2", "Dense_0")),
        ("nonlin_map2.1", "bn", ("nonlin_map2_bn", "BatchNorm_0")),
    ]
    for i in (1, 2):
        m = f"mpnn{i}"
        rows += [
            (f"MPNN{i}.graph_construction.mapping", "linear",
             (m, "graph_mapping", "Dense_0")),
            (f"MPNN{i}.BN", "bn", (m, "bn_in", "BatchNorm_0")),
            (f"MPNN{i}.MPNN.theta.0", "linear", (m, "theta0", "Dense_0")),
            (f"MPNN{i}.MPNN.bn1", "bn", (m, "bn_out", "BatchNorm_0")),
        ]
    rows += [(f"fc.fc{k}", "linear", (f"fc{k}", "Dense_0"))
             for k in (1, 2, 3, 4)]
    return rows


def _logo_layout() -> Layout:
    """``(torch prefix, kind, flax path)`` for every LOGO layer; the flax
    tree sits under ``core``."""
    rows = [("nonlin_map", "linear", ("core", "nonlin_map", "Dense_0")),
            ("MPNN.theta.0", "linear", ("core", "MPNN", "theta0", "Dense_0")),
            ("fc.fc1", "linear", ("core", "fc1", "Dense_0")),
            ("fc.fc2", "linear", ("core", "fc2", "Dense_0")),
            ("cls", "linear", ("core", "cls", "Dense_0"))]
    rows += [(f"graph_attn_blk.{name}", "linear",
              ("core", "graph_attn_blk", name, "Dense_0"))
             for name in ("W_Z_T", "W_Z_G", "W_R_T", "W_R_G", "W_h_T", "W_h")]
    for i in (1, 2, 3):
        rows += [(f"TD.bi_lstm{i}", "lstm", ("core", "TD", f"bi_lstm{i}_fwd")),
                 (f"TD.bi_lstm{i}", "lstm_reverse",
                  ("core", "TD", f"bi_lstm{i}_bwd"))]
    return rows


def _heads(tree: Dict[str, Any]) -> List[str]:
    """The GAT heads ``attention_{i}`` in a flax subtree, in order."""
    return [f"attention_{i}"
            for i in range(sum(k.startswith("attention_") for k in tree))]


def _gat_rows(prefix: str, path: Tuple[str, ...]) -> Layout:
    """A GraphAttentionLayer's rows: the torch prefix, the flax path."""
    return [(f"{prefix}.linear", "linear", path + ("linear", "Dense_0")),
            (f"{prefix}.attention", "attention", path)]


def _tcn_rows(name: str, downsample: bool,
              at: Tuple[str, ...] = ()) -> Layout:
    """A TemporalConvNet's rows: the torch prefix ``name``, the flax path
    ``at`` (``(name,)`` where empty)."""
    at = at or (name,)
    rows = []
    for block in (1, 2):
        rows += [(f"{name}.conv_block{block}.0", "conv",
                  at + (f"conv{block}", "Conv_0")),
                 (f"{name}.conv_block{block}.2", "bn",
                  at + (f"bn{block}", "BatchNorm1d_0", "BatchNorm_0"))]
    if downsample:
        rows.append((f"{name}.downsample0", "conv",
                     at + ("downsample0", "Conv_0")))
    return rows


def _stagnn_layout(params: Dict[str, Any]) -> Layout:
    """``(torch prefix, kind, flax path)`` for every STAGNN layer; the head
    count is read off the tree."""
    rows = [(f"gcn{i}.linear", "linear", (f"gcn{i}", "linear", "Dense_0"))
            for i in (1, 2)]
    for gat in ("gat1", "gat2"):
        for head in _heads(params[gat]):
            rows += _gat_rows(f"{gat}.{head}", (gat, head))
    for tcn in ("tcn1", "tcn2"):
        rows += _tcn_rows(tcn, "downsample0" in params[tcn])
    for enc in ("temporal_encoder1", "temporal_encoder2"):
        rows += [(f"{enc}.linears.{i}", "linear",
                  (enc, f"linear_{i}", "Dense_0"))
                 for i in range(len(params[enc]))]
    rows.append(("fc", "linear", ("fc", "Dense_0")))
    return rows


def _stfa_layout(params: Dict[str, Any]) -> Layout:
    """``(torch prefix, kind, flax path)`` for every STFA layer: the heads
    sit at the top of the flax tree and under ``gat`` in the port."""
    rows = []
    for head in _heads(params):
        rows += _gat_rows(f"gat.{head}", (head,))
    return rows + [("v", "linear", ("v", "Dense_0")),
                   ("lstm", "lstm", ("lstm",)),
                   ("fc", "linear", ("fc", "Dense_0"))]


def _hagcn_layout() -> Layout:
    """``(torch prefix, kind, flax path)`` for every HAGCN layer."""
    rows = []
    for i in (1, 2, 3):
        rows += [(f"TD.bi_lstm{i}", "lstm", ("TD", f"bi_lstm{i}_fwd")),
                 (f"TD.bi_lstm{i}", "lstm_reverse", ("TD", f"bi_lstm{i}_bwd")),
                 (f"gin{i}.eps", "param", (f"gin{i}", "eps")),
                 (f"gin{i}.mlp.0", "linear", (f"gin{i}", "mlp0", "Dense_0")),
                 (f"gin{i}.mlp.2", "linear", (f"gin{i}", "mlp1", "Dense_0"))]
        rows += [(f"gnn{i}.{name}", "linear", (f"gnn{i}", name, "Dense_0"))
                 for name in ("model", "rank")]
        rows += [(f"gnn{i}.mlp.{2 * k}", "linear",
                  (f"gnn{i}", f"mlp{k}", "Dense_0")) for k in (0, 1)]
    return rows + [("fc.0", "linear", ("fc0", "Dense_0")),
                   ("fc.2", "linear", ("fc1", "Dense_0"))]


def _rgcnu_layout() -> Layout:
    """``(torch prefix, kind, flax path)`` for every RGCNU layer;
    ``fusion_cnn2`` is a bare flax ``nn.Conv``, with no ``Conv_0`` level."""
    return [("adj.trainable_theta1", "linear", ("adj_theta1", "Dense_0")),
            ("adj.trainable_theta2", "linear", ("adj_theta2", "Dense_0")),
            ("scl.gcn1.linear", "linear", ("gcn1", "linear", "Dense_0")),
            ("scl.gcn2.linear", "linear", ("gcn2", "linear", "Dense_0")),
            ("scl.conv1d", "conv", ("scl_conv", "Conv_0")),
            ("tdl.lstm", "lstm", ("tdl_lstm",)),
            ("fusion.cnn1", "conv", ("fusion_cnn1", "Conv_0")),
            ("fusion.cnn2", "conv", ("fusion_cnn2",)),
            ("fusion.fc1", "linear", ("fusion_fc1", "Dense_0")),
            ("fusion.fc2", "linear", ("fusion_fc2", "Dense_0"))]


def _gru_cm_layout() -> Layout:
    """``(torch prefix, kind, flax path)`` for every GRU_CM layer."""
    return [("input_linear", "linear", ("input_linear", "Dense_0")),
            ("gnn.edge_mlp.0.weight", "param_t", ("gnn", "edge_kernel")),
            ("gnn.edge_mlp.0.bias", "param", ("gnn", "edge_bias")),
            ("gnn.node_mlp.0", "linear", ("gnn", "node_mlp", "Dense_0")),
            ("gru", "gru", ("gru",)),
            ("output_linear", "linear", ("output_linear", "Dense_0"))]


def _stgnn_layout() -> Layout:
    """``(torch prefix, kind, flax path)`` for every STGNN layer."""
    return [("chebnet.filters", "param", ("chebnet", "filters")),
            ("gru", "gru", ("gru",)),
            ("fc", "linear", ("fc", "Dense_0"))]


def _dvgtformer_layout(params: Dict[str, Any]) -> Layout:
    """``(torch prefix, kind, flax path)`` for every DVGTformer layer; the
    block and head counts are read off the tree. Each head's q/k/v is a
    ``LinearParams`` (``{q,k,v}<h>/Dense_0``) in the flax tree."""
    rows = [("linear_t", "linear", ("linear_t", "Dense_0")),
            ("linear_x", "linear", ("linear_x", "Dense_0")),
            ("t_v", "param", ("t_v",)), ("x_v", "param", ("x_v",)),
            ("output_layer.0", "linear", ("out0", "Dense_0")),
            ("output_layer.2", "linear", ("out1", "Dense_0"))]
    blocks = sum(k.startswith("tvgt") for k in params)
    heads = sum(k.startswith("q") for k in params["tvgt0"])
    for i in range(blocks):
        for kind, pre, tag in (("tvgt", "tvgtformer_blocks", "temp"),
                               ("svgt", "svgtformer_blocks", "spat")):
            blk, at = f"{pre}.{i}", (f"{kind}{i}",)
            rows += [(f"{blk}.linears_{qkv.upper()}_{tag}.{h}", "linear",
                      at + (f"{qkv}{h}", "Dense_0"))
                     for qkv in "qkv" for h in range(heads)]
            rows += [(f"{blk}.W_O_{tag}", "linear", at + ("W_O", "Dense_0")),
                     (f"{blk}.layer_norm1_{tag}", "layernorm",
                      at + ("layer_norm1",)),
                     (f"{blk}.layer_norm2_{tag}", "layernorm",
                      at + ("layer_norm2",)),
                     (f"{blk}.feed_forward_{tag}.0", "linear",
                      at + ("ff0", "Dense_0")),
                     (f"{blk}.feed_forward_{tag}.2", "linear",
                      at + ("ff1", "Dense_0"))]
    return rows


def _hiercorrpool_layout() -> Layout:
    """``(torch prefix, kind, flax path)`` for every HierCorrPool layer:
    the flax tree sits under ``core``, the torch keys are flat."""
    tp = ("core", "Time_Preprocessing")
    rows = []
    for i in (1, 2, 3):
        rows += [(f"Time_Preprocessing.conv_block{i}.0", "conv",
                  tp + (f"conv{i}", "Conv_0")),
                 (f"Time_Preprocessing.conv_block{i}.1", "bn",
                  tp + (f"bn{i}", "BatchNorm1d_0", "BatchNorm_0"))]
    gc = ("core", "gc1")
    return rows + [
        ("gc1.Message_Passing.theta.0", "linear",
         gc + ("Message_Passing", "theta0", "Dense_0")),
        ("gc1.Graph_Clustering.dimension_mapping", "linear",
         gc + ("Graph_Clustering", "dimension_mapping", "Dense_0")),
        ("gc1.Graph_Clustering.matrix", "linear",
         gc + ("Graph_Clustering", "matrix", "Dense_0")),
        ("fc_0", "linear", ("core", "fc_0", "Dense_0")),
        ("fc_1", "linear", ("core", "fc_1", "Dense_0"))]


def _astgcnn_layout() -> Layout:
    """``(torch prefix, kind, flax path)`` for every ASTGCNN layer; its TCN
    keeps 14 channels, so it has no ``downsample0``."""
    return _tcn_rows("tcn", False) + [
        ("gate.theta", "linear", ("gate_theta", "Dense_0")),
        ("gate.bias", "param", ("gate_bias",)),
        ("distance_module.P.weight", "param_t", ("distance_P", "kernel")),
        ("chebnet.filters", "param", ("chebnet", "filters")),
        ("fc", "linear", ("fc", "Dense_0"))]


def _st_conv_layout() -> Layout:
    """``(torch prefix, kind, flax path)`` for every ST_Conv layer (the
    layer-1 modules, the only ones its forward calls); ``cnn_layer_1``'s
    convolution is a bare flax ``nn.Conv``, with no ``Conv_0`` level."""
    return [("gcn_layer_1.theta.0", "linear",
             ("gcn_layer_1", "theta0", "Dense_0")),
            ("cnn_layer_1.conv", "conv", ("cnn_layer_1", "conv")),
            ("cnn_layer_1.bn", "bn",
             ("cnn_layer_1", "bn", "BatchNorm1d_0", "BatchNorm_0")),
            *_tcn_rows("tcn_layer_1", False),
            *[(f"theta{i}", "param", (f"theta{i}",)) for i in (1, 2, 3, 4)],
            ("fc", "linear", ("fc", "Dense_0"))]


def _st_gcn_layout(params: Dict[str, Any]) -> Layout:
    """``(torch prefix, kind, flax path)`` for every ST_GCN layer; the
    block count is read off the tree. Each block is the reference's
    ``sg_tcn.layers.{i}``: ``.0`` the MPNN, ``.1`` the TCN (10 channels,
    no ``downsample0``)."""
    rows = []
    for i in range(sum(k.startswith("mpnn") for k in params["sg_tcn"])):
        layer = f"sg_tcn.layers.{i}"
        rows.append((f"{layer}.0.theta.0", "linear",
                     ("sg_tcn", f"mpnn{i}", "theta0", "Dense_0")))
        rows += _tcn_rows(f"{layer}.1", False, ("sg_tcn", f"tcn{i}"))
    return rows + [("fc1", "linear", ("fc1", "Dense_0")),
                   ("fc2", "linear", ("fc2", "Dense_0"))]


def _sagcn_layout() -> Layout:
    """``(torch prefix, kind, flax path)`` for every SAGCN layer."""
    rows = [("gcn1.linear", "linear", ("gcn1", "linear", "Dense_0"))]
    for proj in ("proj1", "proj2"):
        rows += [(f"{proj}.{name}", "linear", (proj, name, "Dense_0"))
                 for name in ("project_matrices", "linear")]
    rows += [(f"attn.{name}", "linear", ("attn", name, "Dense_0"))
             for name in ("tanh_layer", "softmax_layer")]
    return rows + [("fc", "linear", ("fc", "Dense_0"))]


def _agcn_tf_layout(params: Dict[str, Any]) -> Layout:
    """``(torch prefix, kind, flax path)`` for every AGCN_TF layer; the head
    count is read off the tree."""
    rows = []
    for kind in ("spa", "tem"):
        rows += [(f"attention_{kind}_adj.{2 * i}", "linear",
                  (f"{kind}_adj{i}", "Dense_0")) for i in (0, 1)]
    rows += [(f"{gnn}.theta.0", "linear", (gnn, "theta0", "Dense_0"))
             for gnn in ("spatial_gnn", "temporal_gnn")]
    for h in range(sum(k.startswith("head") for k in params)):
        rows += [(f"self_attention.heads.{h}.{w}", "linear",
                  (f"head{h}", w, "Dense_0")) for w in ("W_q", "W_k", "W_v")]
    return rows + [("fc", "linear", ("fc", "Dense_0"))]


def _stmsgcn_layout(params: Dict[str, Any]) -> Layout:
    """``(torch prefix, kind, flax path)`` for every STMSGCN layer; the GCN
    count is read off the tree."""
    rows = [(f"gcn_layers.{i}.linear", "linear",
             (f"gcn{i}", "linear", "Dense_0"))
            for i in range(sum(k.startswith("gcn") for k in params))]
    return rows + [("gru_layer.gru", "gru", ("gru",)),
                   ("fc", "linear", ("fc", "Dense_0"))]


def _stnet_layout(params: Dict[str, Any]) -> Layout:
    """``(torch prefix, kind, flax path)`` for every STNet layer; the
    ChebNet and MLP layer counts are read off the tree. The MLPs are the
    reference's ``nn.Sequential``, their Linears at even indices."""
    rows = [("cnn", "conv", ("cnn", "Conv_0"))]
    rows += [(f"chebnets.{i}.filters", "param", (f"chebnet{i}", "filters"))
             for i in range(sum(k.startswith("chebnet") for k in params))]
    for mlp in ("encoder", "decoder"):
        rows += [(f"{mlp}.{2 * i}", "linear", (mlp, f"Linear_{i}", "Dense_0"))
                 for i in range(len(params[mlp]))]
    return rows + [("lstm", "lstm", ("lstm",)),
                   ("linear", "linear", ("linear", "Dense_0"))]


def _gat_lstm_layout(params: Dict[str, Any]) -> Layout:
    """``(torch prefix, kind, flax path)`` for every GAT_LSTM layer; the GAT
    and LSTM counts are read off the tree."""
    rows = []
    for i in range(sum(k.startswith("gat") for k in params)):
        rows += _gat_rows(f"gat_layers.{i}", (f"gat{i}",))
    rows += [(f"lstm_layers.{i}", "lstm", (f"lstm{i}",))
             for i in range(sum(k.startswith("lstm") for k in params))]
    return rows + [("fc", "linear", ("fc", "Dense_0"))]


def _gdagdl_layout(params: Dict[str, Any]) -> Layout:
    """``(torch prefix, kind, flax path)`` for every GDAGDL layer; the GAT
    and MLP layer counts are read off the tree."""
    rows = [("node_importance_linear", "linear",
             ("node_importance_linear", "Dense_0"))]
    for i in range(sum(k.startswith("gat") for k in params)):
        rows += _gat_rows(f"gat_layers.{i}", (f"gat{i}",))
    for mlp in ("encoder", "decoder"):
        rows += [(f"{mlp}.{2 * i}", "linear", (mlp, f"Linear_{i}", "Dense_0"))
                 for i in range(len(params[mlp]))]
    return rows + [("lstm", "lstm", ("lstm",)),
                   ("linear", "linear", ("linear", "Dense_0"))]


# method -> its layout, from the flax params (head, block and layer counts
# are read off the tree).
_LAYOUTS = {"FC_STGNN": lambda params: _fc_stgnn_layout(),
            "LOGO": lambda params: _logo_layout(),
            "HAGCN": lambda params: _hagcn_layout(),
            "RGCNU": lambda params: _rgcnu_layout(),
            "STAGNN": _stagnn_layout, "STFA": _stfa_layout,
            "GRU_CM": lambda params: _gru_cm_layout(),
            "STGNN": lambda params: _stgnn_layout(),
            "DVGTformer": _dvgtformer_layout,
            "HierCorrPool": lambda params: _hiercorrpool_layout(),
            "ASTGCNN": lambda params: _astgcnn_layout(),
            "ST_Conv": lambda params: _st_conv_layout(),
            "HierCorrPool_bearing": lambda params: _hiercorrpool_layout(),
            "ST_GCN": _st_gcn_layout,
            "SAGCN": lambda params: _sagcn_layout(),
            "AGCN_TF": _agcn_tf_layout, "STMSGCN": _stmsgcn_layout,
            "STNet": _stnet_layout, "GAT_LSTM": _gat_lstm_layout,
            "GDAGDL": _gdagdl_layout,
            "LOGO_bearing": lambda params: _logo_layout()}


def _get(tree: Dict[str, Any], path: Tuple[str, ...]) -> Dict[str, Any]:
    for key in path:
        tree = tree[key]
    return tree


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def from_jax_variables(method: str,
                       variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map the JAX package's ``{"params", "batch_stats"}`` for ``method``
    onto the port's ``state_dict`` (CPU tensors, for
    ``load_state_dict(strict=True)``)."""
    if method not in _LAYOUTS:
        raise NotImplementedError(f"from_jax_variables: no method {method}")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for prefix, kind, path in _LAYOUTS[method](params):
        p = _get(params, path)
        if kind in ("lstm", "lstm_reverse", "gru"):
            sfx = "_reverse" if kind == "lstm_reverse" else ""
            sd[f"{prefix}.weight_ih_l0{sfx}"] = _t(np.asarray(p["w_ih"]).T)
            sd[f"{prefix}.weight_hh_l0{sfx}"] = _t(np.asarray(p["w_hh"]).T)
            sd[f"{prefix}.bias_ih_l0{sfx}"] = _t(p["b_ih"])
            sd[f"{prefix}.bias_hh_l0{sfx}"] = _t(p["b_hh"])
        elif kind == "param":
            sd[prefix] = _t(p)
        elif kind == "param_t":
            sd[prefix] = _t(np.asarray(p).T)
        elif kind == "linear":
            sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
            sd[f"{prefix}.bias"] = _t(p["bias"])
        elif kind == "attention":
            sd[f"{prefix}.weight"] = _t(np.asarray(p["att_kernel"]).T)
            sd[f"{prefix}.bias"] = _t(p["att_bias"])
        elif kind == "layernorm":
            sd[f"{prefix}.weight"] = _t(p["scale"])
            sd[f"{prefix}.bias"] = _t(p["bias"])
        elif kind == "conv":
            kernel = np.asarray(p["kernel"])  # (*spatial, in, out)
            sd[f"{prefix}.weight"] = _t(kernel.transpose(
                kernel.ndim - 1, kernel.ndim - 2, *range(kernel.ndim - 2)))
            if "bias" in p:
                sd[f"{prefix}.bias"] = _t(p["bias"])
        else:
            s = _get(stats, path)
            sd[f"{prefix}.weight"] = _t(p["scale"])
            sd[f"{prefix}.bias"] = _t(p["bias"])
            sd[f"{prefix}.running_mean"] = _t(s["mean"])
            sd[f"{prefix}.running_var"] = _t(s["var"])
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(
                0, dtype=torch.long)
    return sd
