"""The plain references against the port's CPU path (its kernels' plain
versions) at tiny widths and at the configurations' own, on several
requests at once: the reference runs requests of different lengths side
by side, each answer as if it ran alone."""

import numpy as np
import pytest
import torch

from portbench.harness.cell import load
from portbench.harness.common import make_weights

CASES = {
    "hagcn-fd001.serve": {"patch_size": 10, "num_patch": 5, "hidden_dim": 8,
                          "encoder_hidden_dim": 6, "output_dim": 4},
    "logo_bearing-phm2012.serve": {"patch_size": 16, "num_patch": 4,
                                   "input_dim": 3, "num_nodes": 5,
                                   "nperseg": 8, "hidden_dim": 2},
    "fc_stgnn-fd003.serve": {"patch_size": 5, "num_patch": 10,
                             "encoder_time_out": 7, "encoder_hidden_dim": 3,
                             "encoder_out_dim": 2, "encoder_conv_kernel": 2,
                             "hidden_dim": 4, "num_sequential": 1,
                             "num_node": 14, "num_windows": 13},
}


def _port(cfg, hp, weights):
    from gnn_rul_tpu_torch.export import build_model
    model = build_model(cfg["method"], cfg["dataset"], cfg["dataset_id"], hp)
    model.load_state_dict(weights)
    return model.eval()


@pytest.mark.parametrize("workload", sorted(CASES))
@pytest.mark.parametrize("tiny", [True, False])
def test_reference_matches_the_port_on_the_cpu(workload, tiny):
    cell = load(workload)
    cfg = dict(cell.config)
    if tiny:
        cfg["model"] = CASES[workload]
    length = cfg["model"]["patch_size"] * cfg["model"]["num_patch"]
    if cfg["input"]["channels"] > 1:
        length = cfg["input"]["length"]
    weights = make_weights(cell.reference.param_specs(cfg), 7,
                           torch.device("cpu"))
    model = _port(cfg, cfg["model"], weights)
    gen = torch.Generator().manual_seed(3)
    reqs = [torch.rand((n, cfg["input"]["channels"], length), generator=gen)
            for n in (3, 1, 4)]
    with torch.no_grad():
        want = [model(r).reshape(-1).double() for r in reqs]
        got = cell.reference.forward(
            {k: v.double() for k, v in weights.items()}, cfg, reqs)
    # The port runs float32 and the reference float64: a gap of a few
    # float32 roundings a layer, under 1e-4 of the answers' largest.
    for w, g in zip(want, got):
        scale = float(g.abs().max())
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * scale + 1e-9)


def test_the_lstm_runs_columns_of_different_lengths_alone():
    from portbench.reference.lstm import bilstm_sum
    gen = torch.Generator().manual_seed(1)
    d, h = 3, 4
    p = {f"l.{n}{s}": torch.randn(shape, generator=gen, dtype=torch.float64)
         for s in ("", "_reverse")
         for n, shape in (("weight_ih_l0", (4 * h, d)),
                          ("weight_hh_l0", (4 * h, h)),
                          ("bias_ih_l0", (4 * h,)), ("bias_hh_l0", (4 * h,)))}
    x = torch.randn((6, 2, d), generator=gen, dtype=torch.float64)
    both = bilstm_sum(x, p, "l", torch.tensor([6, 4]))
    alone = bilstm_sum(x[:4, 1:], p, "l", torch.tensor([4]))
    torch.testing.assert_close(both[:4, 1:], alone, rtol=0, atol=1e-12)
    lstm = torch.nn.LSTM(d, h, bidirectional=True).double()
    with torch.no_grad():
        for k, v in p.items():
            getattr(lstm, k.split(".", 1)[1]).copy_(v)
        ys, _ = lstm(x[:, :1])
    torch.testing.assert_close(bilstm_sum(x[:, :1], p, "l", torch.tensor([6])),
                               ys[..., :h] + ys[..., h:], rtol=0, atol=1e-12)
