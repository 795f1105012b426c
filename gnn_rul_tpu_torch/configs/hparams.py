"""Copy of ``gnn_rul_tpu/configs/hparams.py``: the port keeps its own.

Hyperparameter bank, keyed (dataset, sub_id, method).

All values carried over verbatim from the reference bank
(configs/hparams.py:10-434) — they define the benchmark tiers. Structured
as flat registries instead of the reference's per-dataset classes.

``train_params(dataset, sub_id, method)`` -> num_epochs/batch_size/lr/wd
(+ method-specific loss weights theta/alpha/lambda).
``model_hparams(dataset, sub_id, method)`` -> model constructor kwargs.
"""

from __future__ import annotations

from typing import Dict, Tuple


def _tp(lr=1e-3, wd=1e-4, epochs=81, bs=100, **extra):
    d = {"num_epochs": epochs, "batch_size": bs, "weight_decay": wd,
         "learning_rate": lr}
    d.update(extra)
    return d


AEROENGINE_METHODS = ["ASTGCNN", "GRU_CM", "HAGCN", "ST_Conv", "STFA",
                      "RGCNU", "STAGNN", "HierCorrPool", "LOGO",
                      "DVGTformer", "STGNN", "FC_STGNN"]
BEARING_METHODS = ["ST_GCN", "SAGCN", "STNet", "GAT_LSTM", "STMSGCN",
                   "AGCN_TF", "LOGO_bearing", "HierCorrPool_bearing",
                   "GDAGDL"]

# --------------------------------------------------------------------------
# Train params
# --------------------------------------------------------------------------

_TRAIN: Dict[Tuple[str, str, str], Dict] = {}


def _fill_train(dataset, sub_id, overrides=None, methods=None):
    methods = methods or (BEARING_METHODS if dataset in ("PHM2012", "XJTU_SY")
                          else AEROENGINE_METHODS)
    overrides = overrides or {}
    for m in methods:
        _TRAIN[(dataset, sub_id, m)] = overrides.get(m, _DEFAULTS[dataset][m])


# Per-dataset default train params per method.
_AERO_DEFAULT = {m: _tp() for m in AEROENGINE_METHODS}
_BEARING_DEFAULT = {
    "SAGCN": _tp(lr=1e-4),
    "STNet": _tp(lr=1e-2, wd=1e-2),
    "ST_GCN": _tp(lr=1e-4),
    "GAT_LSTM": _tp(lr=1e-4),
    "GDAGDL": _tp(lr=1e-3),
    "STMSGCN": _tp(lr=1e-2, wd=0),
    "AGCN_TF": _tp(lr=1e-4),
    "LOGO_bearing": _tp(lr=1e-3, theta=0.001),
    "HierCorrPool_bearing": _tp(lr=1e-3),
}
_DEFAULTS = {
    "CMAPSS": _AERO_DEFAULT,
    "NCMAPSS": _AERO_DEFAULT,
    "PHM2012": _BEARING_DEFAULT,
    "XJTU_SY": _BEARING_DEFAULT,
}

# CMAPSS: method-specific loss weights vary by sub-dataset (hparams.py:18,56,96,136).
_fill_train("CMAPSS", "FD001", {
    "LOGO": _tp(theta=0.001), "HAGCN": _tp(alpha=100),
    "RGCNU": _tp(**{"lambda": 0.1})})
_fill_train("CMAPSS", "FD002", {
    "LOGO": _tp(theta=0.01), "HAGCN": _tp(alpha=100),
    "RGCNU": _tp(**{"lambda": 0.1})})
_fill_train("CMAPSS", "FD003", {
    "LOGO": _tp(theta=0.01), "HAGCN": _tp(alpha=100),
    "RGCNU": _tp(**{"lambda": 0.1})})
_fill_train("CMAPSS", "FD004", {
    "LOGO": _tp(theta=0.001), "HAGCN": _tp(alpha=100),
    "RGCNU": _tp(**{"lambda": 0.1})})

# N-CMAPSS (hparams.py:180-193): no STFA; LOGO uses bs 50, wd 0.
_NCM_METHODS = [m for m in AEROENGINE_METHODS if m != "STFA"]
_fill_train("NCMAPSS", None, {
    "LOGO": _tp(wd=0, bs=50, theta=0.001), "HAGCN": _tp(alpha=100),
    "RGCNU": _tp(**{"lambda": 0.1})}, methods=_NCM_METHODS)

for _cond in ("Condition_1", "Condition_2", "Condition_3"):
    _fill_train("PHM2012", _cond)
    _fill_train("XJTU_SY", _cond)

# --------------------------------------------------------------------------
# Model hparams
# --------------------------------------------------------------------------

_MODEL: Dict[Tuple[str, str, str], Dict] = {}

# ---- CMAPSS (hparams.py:31-170)
_CM_SHARED = {
    "ASTGCNN": dict(num_nodes=14, time_length=50, encoder_out_dim=50,
                    output_dim=64, K=3),
    "STFA": dict(patch_size=2, num_patch=25, num_nodes=14, hidden_dim=16,
                 output_dim=5, encoder_hidden_dim=64, num_heads=10,
                 dropout=0.2),
    "ST_Conv": dict(num_nodes=14, time_length=50, kernel_size=6),
    "RGCNU": dict(num_nodes=14, time_length=50, hidden_dim=32,
                  encoder_hidden_dim=32, kernel_size=3, alpha=1),
    "DVGTformer": dict(num_nodes=14, time_length=50, d_model=[144, 248],
                       num_heads=4, lambda_param=0.5, d_ff=[72, 124],
                       dropout=0.1, num_blocks=3),
    "GRU_CM": dict(num_nodes=14, time_length=50, gru_hidden_dim=64),
    "STGNN": dict(patch_size=50, num_patch=1, num_nodes=14, hidden_dim=64,
                  K=3, top_k=10),
}

_MODEL.update({("CMAPSS", "FD001", k): dict(v) for k, v in _CM_SHARED.items()})
_MODEL[("CMAPSS", "FD001", "FC_STGNN")] = dict(
    patch_size=25, num_patch=2, encoder_time_out=27, encoder_hidden_dim=8,
    encoder_out_dim=32, encoder_conv_kernel=2, hidden_dim=8, num_sequential=6,
    num_node=14, num_windows=2)
_MODEL[("CMAPSS", "FD001", "HierCorrPool")] = dict(
    patch_size=25, num_patch=2, input_dim=10, hidden_dim=10,
    embedding_dim=10, num_nodes=14, encoder_conv_kernel=8, num_nodes_out=6)
_MODEL[("CMAPSS", "FD001", "LOGO")] = dict(
    patch_size=10, num_patch=5, num_nodes=14, hidden_dim=8)
_MODEL[("CMAPSS", "FD001", "HAGCN")] = dict(
    patch_size=10, num_patch=5, hidden_dim=64, encoder_hidden_dim=60,
    output_dim=32)
_MODEL[("CMAPSS", "FD001", "STAGNN")] = dict(
    num_nodes=14, time_length=50, hidden_dim=64, output_dim=10, num_heads=3,
    threshold=0)

_MODEL.update({("CMAPSS", "FD002", k): dict(v) for k, v in _CM_SHARED.items()})
_MODEL[("CMAPSS", "FD002", "FC_STGNN")] = dict(
    patch_size=1, num_patch=50, encoder_time_out=3, encoder_hidden_dim=8,
    encoder_out_dim=12, encoder_conv_kernel=2, hidden_dim=8,
    num_sequential=10, num_node=14, num_windows=74)
_MODEL[("CMAPSS", "FD002", "HierCorrPool")] = dict(
    patch_size=10, num_patch=5, input_dim=10, hidden_dim=10,
    embedding_dim=10, num_nodes=14, encoder_conv_kernel=12, num_nodes_out=6)
_MODEL[("CMAPSS", "FD002", "LOGO")] = dict(
    patch_size=2, num_patch=25, num_nodes=14, hidden_dim=6)
_MODEL[("CMAPSS", "FD002", "HAGCN")] = dict(
    patch_size=25, num_patch=2, hidden_dim=64, encoder_hidden_dim=60,
    output_dim=32)
_MODEL[("CMAPSS", "FD002", "STAGNN")] = dict(
    num_nodes=14, time_length=50, hidden_dim=16, output_dim=10, num_heads=3,
    threshold=0)

_MODEL.update({("CMAPSS", "FD003", k): dict(v) for k, v in _CM_SHARED.items()})
_MODEL[("CMAPSS", "FD003", "FC_STGNN")] = dict(
    patch_size=1, num_patch=50, encoder_time_out=3, encoder_hidden_dim=8,
    encoder_out_dim=6, encoder_conv_kernel=2, hidden_dim=24,
    num_sequential=25, num_node=14, num_windows=74)
_MODEL[("CMAPSS", "FD003", "HierCorrPool")] = dict(
    patch_size=5, num_patch=10, input_dim=10, hidden_dim=10,
    embedding_dim=10, num_nodes=14, encoder_conv_kernel=12, num_nodes_out=6)
_MODEL[("CMAPSS", "FD003", "LOGO")] = dict(
    patch_size=10, num_patch=5, num_nodes=14, hidden_dim=32)
_MODEL[("CMAPSS", "FD003", "HAGCN")] = dict(
    patch_size=25, num_patch=2, hidden_dim=64, encoder_hidden_dim=60,
    output_dim=32)
_MODEL[("CMAPSS", "FD003", "STAGNN")] = dict(
    num_nodes=14, time_length=50, hidden_dim=32, output_dim=10, num_heads=3,
    threshold=0)

_MODEL.update({("CMAPSS", "FD004", k): dict(v) for k, v in _CM_SHARED.items()})
_MODEL[("CMAPSS", "FD004", "FC_STGNN")] = dict(
    patch_size=2, num_patch=25, encoder_time_out=4, encoder_hidden_dim=8,
    encoder_out_dim=6, encoder_conv_kernel=2, hidden_dim=8,
    num_sequential=10, num_node=14, num_windows=36)
_MODEL[("CMAPSS", "FD004", "HierCorrPool")] = dict(
    patch_size=10, num_patch=5, input_dim=10, hidden_dim=10,
    embedding_dim=10, num_nodes=14, encoder_conv_kernel=12, num_nodes_out=6)
_MODEL[("CMAPSS", "FD004", "LOGO")] = dict(
    patch_size=10, num_patch=5, num_nodes=14, hidden_dim=10)
_MODEL[("CMAPSS", "FD004", "HAGCN")] = dict(
    patch_size=50, num_patch=1, hidden_dim=64, encoder_hidden_dim=60,
    output_dim=32)
_MODEL[("CMAPSS", "FD004", "STAGNN")] = dict(
    num_nodes=14, time_length=50, hidden_dim=32, output_dim=10, num_heads=3,
    threshold=0)

# ---- N-CMAPSS (hparams.py:195-213)
_MODEL[("NCMAPSS", None, "FC_STGNN")] = dict(
    patch_size=2, num_patch=25, encoder_time_out=4, encoder_hidden_dim=8,
    encoder_out_dim=32, encoder_conv_kernel=2, hidden_dim=8,
    num_sequential=6, num_node=20, num_windows=36)
_MODEL[("NCMAPSS", None, "HierCorrPool")] = dict(
    patch_size=1, num_patch=50, input_dim=10, hidden_dim=10,
    embedding_dim=10, num_nodes=20, encoder_conv_kernel=32, num_nodes_out=6)
_MODEL[("NCMAPSS", None, "LOGO")] = dict(
    patch_size=5, num_patch=10, num_nodes=20, hidden_dim=10)
_MODEL[("NCMAPSS", None, "ASTGCNN")] = dict(
    num_nodes=20, time_length=50, encoder_out_dim=50, output_dim=64, K=3)
_MODEL[("NCMAPSS", None, "ST_Conv")] = dict(
    num_nodes=20, time_length=50, kernel_size=6)
_MODEL[("NCMAPSS", None, "HAGCN")] = dict(
    patch_size=25, num_patch=2, hidden_dim=64, encoder_hidden_dim=60,
    output_dim=32)
_MODEL[("NCMAPSS", None, "RGCNU")] = dict(
    num_nodes=20, time_length=50, hidden_dim=32, encoder_hidden_dim=32,
    kernel_size=3, alpha=1)
_MODEL[("NCMAPSS", None, "STAGNN")] = dict(
    num_nodes=20, time_length=50, hidden_dim=32, output_dim=10, num_heads=3,
    threshold=0)
_MODEL[("NCMAPSS", None, "DVGTformer")] = dict(
    num_nodes=20, time_length=50, d_model=[144, 248], num_heads=4,
    lambda_param=0.5, d_ff=[72, 124], dropout=0.1, num_blocks=3)
_MODEL[("NCMAPSS", None, "GRU_CM")] = dict(
    num_nodes=20, time_length=50, gru_hidden_dim=64)
_MODEL[("NCMAPSS", None, "STGNN")] = dict(
    patch_size=10, num_patch=5, num_nodes=20, hidden_dim=64, K=3, top_k=10)

# ---- PHM2012 (hparams.py:234-320)
_MODEL[("PHM2012", "Condition_1", "SAGCN")] = dict(
    num_patch=160, patch_size=16, gcn_hidden_dim=100, attention_hidden_dim=100)
_MODEL[("PHM2012", "Condition_1", "STNet")] = dict(
    num_patch=20, patch_size=128, num_nodes=9, nperseg=16, input_dim=9,
    Cheb_layers=[300, 200, 100], lstm_hidden_dim=10, autoencoder_hidden_dim=50)
_MODEL[("PHM2012", "Condition_1", "ST_GCN")] = dict(
    num_patch=40, patch_size=64, dropout=0.2)
_MODEL[("PHM2012", "Condition_1", "GAT_LSTM")] = dict(
    num_patch=40, patch_size=64, hidden_dim=[300, 200, 100],
    lstm_hidden_dim=[30, 20], dropout=0.2)
_MODEL[("PHM2012", "Condition_1", "GDAGDL")] = dict(
    num_patch=128, patch_size=20, num_nodes=3, nperseg=4, input_dim=6,
    gat_layer_dim=[300, 150, 50], lstm_hidden_dim=20,
    autoencoder_hidden_dim=256, autoencoder_out_dim=50)
_MODEL[("PHM2012", "Condition_1", "STMSGCN")] = dict(
    num_patch=160, patch_size=16, interval=6, band_width=5,
    gcn_dims=[16, 64, 16, 1], gru_hidden_dim=8)
_MODEL[("PHM2012", "Condition_1", "AGCN_TF")] = dict(
    num_patch=40, patch_size=64, hidden_adj_dim=100, hidden_gnn_dim=100)
_MODEL[("PHM2012", "Condition_1", "LOGO_bearing")] = dict(
    patch_size=64, num_patch=40, input_dim=9, num_nodes=5, nperseg=8,
    hidden_dim=10)
_MODEL[("PHM2012", "Condition_1", "HierCorrPool_bearing")] = dict(
    patch_size=32, num_patch=80, input_dim=5, hidden_dim=10,
    embedding_dim=10, num_nodes=5, nperseg=8, encoder_conv_kernel=48,
    num_nodes_out=6)

_MODEL[("PHM2012", "Condition_2", "SAGCN")] = dict(
    num_patch=128, patch_size=20, gcn_hidden_dim=1000,
    attention_hidden_dim=200)
_MODEL[("PHM2012", "Condition_2", "STNet")] = dict(
    num_patch=20, patch_size=128, num_nodes=9, nperseg=16, input_dim=9,
    Cheb_layers=[300, 200, 100], lstm_hidden_dim=10, autoencoder_hidden_dim=50)
_MODEL[("PHM2012", "Condition_2", "ST_GCN")] = dict(
    num_patch=160, patch_size=16, dropout=0.2)
_MODEL[("PHM2012", "Condition_2", "GAT_LSTM")] = dict(
    num_patch=80, patch_size=32, hidden_dim=[300, 200, 100],
    lstm_hidden_dim=[30, 20], dropout=0.2)
_MODEL[("PHM2012", "Condition_2", "GDAGDL")] = dict(
    num_patch=128, patch_size=20, num_nodes=3, nperseg=4, input_dim=6,
    gat_layer_dim=[300, 150, 50], lstm_hidden_dim=20,
    autoencoder_hidden_dim=256, autoencoder_out_dim=50)
_MODEL[("PHM2012", "Condition_2", "STMSGCN")] = dict(
    num_patch=128, patch_size=20, interval=2, band_width=3,
    gcn_dims=[16, 64, 16, 1], gru_hidden_dim=8)
_MODEL[("PHM2012", "Condition_2", "AGCN_TF")] = dict(
    num_patch=40, patch_size=64, hidden_adj_dim=100, hidden_gnn_dim=100)
_MODEL[("PHM2012", "Condition_2", "LOGO_bearing")] = dict(
    patch_size=64, num_patch=40, input_dim=9, num_nodes=5, nperseg=8,
    hidden_dim=10)
_MODEL[("PHM2012", "Condition_2", "HierCorrPool_bearing")] = dict(
    patch_size=128, num_patch=20, input_dim=9, hidden_dim=10,
    embedding_dim=10, num_nodes=9, nperseg=16, encoder_conv_kernel=20,
    num_nodes_out=6)

_MODEL[("PHM2012", "Condition_3", "SAGCN")] = dict(
    num_patch=128, patch_size=20, gcn_hidden_dim=1000,
    attention_hidden_dim=200)
_MODEL[("PHM2012", "Condition_3", "STNet")] = dict(
    num_patch=80, patch_size=32, num_nodes=5, nperseg=8, input_dim=5,
    Cheb_layers=[300, 200, 100], lstm_hidden_dim=10, autoencoder_hidden_dim=50)
_MODEL[("PHM2012", "Condition_3", "ST_GCN")] = dict(
    num_patch=40, patch_size=64, dropout=0.2)
_MODEL[("PHM2012", "Condition_3", "GAT_LSTM")] = dict(
    num_patch=40, patch_size=64, hidden_dim=[300, 200, 100],
    lstm_hidden_dim=[30, 20], dropout=0.2)
_MODEL[("PHM2012", "Condition_3", "GDAGDL")] = dict(
    num_patch=80, patch_size=32, num_nodes=5, nperseg=8, input_dim=5,
    gat_layer_dim=[300, 150, 50], lstm_hidden_dim=20,
    autoencoder_hidden_dim=256, autoencoder_out_dim=50)
_MODEL[("PHM2012", "Condition_3", "STMSGCN")] = dict(
    num_patch=160, patch_size=16, interval=6, band_width=5,
    gcn_dims=[16, 64, 16, 1], gru_hidden_dim=8)
_MODEL[("PHM2012", "Condition_3", "AGCN_TF")] = dict(
    num_patch=40, patch_size=64, hidden_adj_dim=100, hidden_gnn_dim=100)
_MODEL[("PHM2012", "Condition_3", "LOGO_bearing")] = dict(
    patch_size=64, num_patch=40, input_dim=9, num_nodes=5, nperseg=8,
    hidden_dim=10)
_MODEL[("PHM2012", "Condition_3", "HierCorrPool_bearing")] = dict(
    patch_size=64, num_patch=40, input_dim=9, hidden_dim=10,
    embedding_dim=10, num_nodes=5, nperseg=8, encoder_conv_kernel=28,
    num_nodes_out=6)

# ---- XJTU-SY (hparams.py:345-432)
_MODEL[("XJTU_SY", "Condition_1", "SAGCN")] = dict(
    num_patch=32, patch_size=1024, gcn_hidden_dim=1000,
    attention_hidden_dim=100)
_MODEL[("XJTU_SY", "Condition_1", "STNet")] = dict(
    num_patch=128, patch_size=256, num_nodes=9, nperseg=16, input_dim=17,
    Cheb_layers=[300, 200, 100], lstm_hidden_dim=10, autoencoder_hidden_dim=50)
_MODEL[("XJTU_SY", "Condition_1", "ST_GCN")] = dict(
    num_patch=1024, patch_size=32, dropout=0.3)
_MODEL[("XJTU_SY", "Condition_1", "GAT_LSTM")] = dict(
    num_patch=32, patch_size=1024, hidden_dim=[300, 200, 100],
    lstm_hidden_dim=[30, 20], dropout=0.2)
_MODEL[("XJTU_SY", "Condition_1", "GDAGDL")] = dict(
    num_patch=32, patch_size=1024, num_nodes=17, nperseg=32, input_dim=33,
    gat_layer_dim=[300, 150, 50], lstm_hidden_dim=20,
    autoencoder_hidden_dim=256, autoencoder_out_dim=50)
_MODEL[("XJTU_SY", "Condition_1", "STMSGCN")] = dict(
    num_patch=256, patch_size=128, interval=3, band_width=5,
    gcn_dims=[16, 64, 16, 1], gru_hidden_dim=8)
_MODEL[("XJTU_SY", "Condition_1", "AGCN_TF")] = dict(
    num_patch=128, patch_size=256, hidden_adj_dim=100, hidden_gnn_dim=100)
_MODEL[("XJTU_SY", "Condition_1", "LOGO_bearing")] = dict(
    patch_size=1024, num_patch=32, input_dim=33, num_nodes=17, nperseg=32,
    hidden_dim=10)
_MODEL[("XJTU_SY", "Condition_1", "HierCorrPool_bearing")] = dict(
    patch_size=512, num_patch=64, input_dim=17, hidden_dim=10,
    embedding_dim=10, num_nodes=17, nperseg=32, encoder_conv_kernel=40,
    num_nodes_out=6)

_MODEL[("XJTU_SY", "Condition_2", "SAGCN")] = dict(
    num_patch=32, patch_size=1024, gcn_hidden_dim=1000,
    attention_hidden_dim=200)
_MODEL[("XJTU_SY", "Condition_2", "STNet")] = dict(
    num_patch=32, patch_size=1024, num_nodes=17, nperseg=32, input_dim=33,
    Cheb_layers=[300, 200, 100], lstm_hidden_dim=10, autoencoder_hidden_dim=50)
_MODEL[("XJTU_SY", "Condition_2", "ST_GCN")] = dict(
    num_patch=2048, patch_size=16, dropout=0.2)
_MODEL[("XJTU_SY", "Condition_2", "GAT_LSTM")] = dict(
    num_patch=64, patch_size=512, hidden_dim=[300, 200, 100],
    lstm_hidden_dim=[30, 20], dropout=0.2)
_MODEL[("XJTU_SY", "Condition_2", "GDAGDL")] = dict(
    num_patch=32, patch_size=1024, num_nodes=17, nperseg=32, input_dim=33,
    gat_layer_dim=[300, 150, 50], lstm_hidden_dim=20,
    autoencoder_hidden_dim=256, autoencoder_out_dim=50)
_MODEL[("XJTU_SY", "Condition_2", "STMSGCN")] = dict(
    num_patch=128, patch_size=256, interval=6, band_width=10,
    gcn_dims=[16, 64, 16, 1], gru_hidden_dim=8)
_MODEL[("XJTU_SY", "Condition_2", "AGCN_TF")] = dict(
    num_patch=128, patch_size=256, hidden_adj_dim=100, hidden_gnn_dim=100)
_MODEL[("XJTU_SY", "Condition_2", "LOGO_bearing")] = dict(
    patch_size=1024, num_patch=32, input_dim=33, num_nodes=17, nperseg=32,
    hidden_dim=10)
_MODEL[("XJTU_SY", "Condition_2", "HierCorrPool_bearing")] = dict(
    patch_size=256, num_patch=128, input_dim=17, hidden_dim=10,
    embedding_dim=10, num_nodes=9, nperseg=16, encoder_conv_kernel=72,
    num_nodes_out=6)

_MODEL[("XJTU_SY", "Condition_3", "SAGCN")] = dict(
    num_patch=32, patch_size=1024, gcn_hidden_dim=1000,
    attention_hidden_dim=200)
_MODEL[("XJTU_SY", "Condition_3", "STNet")] = dict(
    num_patch=64, patch_size=512, num_nodes=17, nperseg=32, input_dim=17,
    Cheb_layers=[300, 200, 100], lstm_hidden_dim=10, autoencoder_hidden_dim=50)
_MODEL[("XJTU_SY", "Condition_3", "ST_GCN")] = dict(
    num_patch=2048, patch_size=16, dropout=0.2)
_MODEL[("XJTU_SY", "Condition_3", "GAT_LSTM")] = dict(
    num_patch=32, patch_size=1024, hidden_dim=[300, 200, 100],
    lstm_hidden_dim=[30, 20], dropout=0.2)
_MODEL[("XJTU_SY", "Condition_3", "GDAGDL")] = dict(
    num_patch=32, patch_size=1024, num_nodes=17, nperseg=32, input_dim=33,
    gat_layer_dim=[300, 150, 50], lstm_hidden_dim=20,
    autoencoder_hidden_dim=256, autoencoder_out_dim=50)
_MODEL[("XJTU_SY", "Condition_3", "STMSGCN")] = dict(
    num_patch=256, patch_size=128, interval=3, band_width=5,
    gcn_dims=[16, 64, 16, 1], gru_hidden_dim=8)
_MODEL[("XJTU_SY", "Condition_3", "AGCN_TF")] = dict(
    num_patch=256, patch_size=128, hidden_adj_dim=100, hidden_gnn_dim=100)
_MODEL[("XJTU_SY", "Condition_3", "LOGO_bearing")] = dict(
    patch_size=1024, num_patch=32, input_dim=33, num_nodes=17, nperseg=32,
    hidden_dim=10)
_MODEL[("XJTU_SY", "Condition_3", "HierCorrPool_bearing")] = dict(
    patch_size=256, num_patch=128, input_dim=17, hidden_dim=10,
    embedding_dim=10, num_nodes=9, nperseg=16, encoder_conv_kernel=72,
    num_nodes_out=6)


def _norm_sub_id(dataset: str, sub_id):
    return None if dataset == "NCMAPSS" else sub_id


def train_params(dataset: str, sub_id, method: str) -> Dict:
    key = (dataset, _norm_sub_id(dataset, sub_id), method)
    if key not in _TRAIN:
        raise KeyError(f"No train params for {key}")
    return dict(_TRAIN[key])


def model_hparams(dataset: str, sub_id, method: str) -> Dict:
    key = (dataset, _norm_sub_id(dataset, sub_id), method)
    if key not in _MODEL:
        raise KeyError(f"No model hparams for {key}")
    return dict(_MODEL[key])
