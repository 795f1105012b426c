"""Kernel #4, the Bi-LSTM recurrence's forward (csrc/fused_lstm.cu), at
every step design its plan chooses: on the card against
``lstm_trajectory_plain`` on the card, ys, cs and c_fin, fp32 and bf16, with
the wrapper's count of launches by step; on the CPU, the wrapper's plan
field, its counter and the stamped build. This file imports no JAX, so the
card's machine runs it:

    python -m pytest --noconftest -m cuda tests/test_torch_lstm_step.py
"""

import ctypes

import pytest
import torch

from gnn_rul_tpu_torch.ops.kernels import build, fused_lstm
from gnn_rul_tpu_torch.ops.kernels.fused_lstm import (lstm_recurrence,
                                                      lstm_trajectory_plain)

# (T, B, H, G) and the step an H100's plan takes: HAGCN's calls for a
# request of 259 windows (T = 14 * 259, the 5 patches its columns); one
# step; a T that is no multiple of the ring's block (16); H = 30, whose
# rows of H floats are no multiple of 16 bytes; the vectorized HAGCN's five
# seeds a call; LOGO_bearing's H = 60 (one ring CTA an SM, more than a
# wave: the classic step) and H = 30 (two waves of several ring CTAs an
# SM); LOGO_bearing's five seeds at H = 30 (2,000 CTAs: classic).
CASES = [(14 * 259, 5, 60, 1, "ring"), (14 * 259, 5, 120, 1, "ring"),
         (1, 5, 60, 1, "ring"), (1, 5, 120, 1, "ring"),
         (13, 5, 60, 1, "ring"), (37, 5, 120, 1, "ring"),
         (50, 5, 30, 1, "ring"), (1400, 25, 120, 5, "ring"),
         (1139, 200, 60, 1, "classic"), (1139, 200, 30, 1, "ring"),
         (100, 1000, 30, 5, "classic")]
ATOL, RTOL = 1e-5, 1e-4  # fp32 kernel against fp32 plain (chip_smoke.py)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the kernels run only on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(t, b, h, groups, dtype):
    gen = torch.Generator().manual_seed(t * 1000 + b * 10 + h)
    xg = torch.randn((t, 2, b, 4 * h), generator=gen)
    w = (torch.rand((groups, 2, h, 4 * h), generator=gen) * 2 - 1) / h ** 0.5
    w = w[0] if groups == 1 else w
    return (xg.to("cuda", dtype).contiguous(),
            w.to("cuda", dtype).contiguous())


def _bf16_ulp(v):
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,b,h,groups,step", CASES)
def test_forward_matches_plain_at_every_step_design(t, b, h, groups, step,
                                                    dtype):
    _card()
    xg, w = _inputs(t, b, h, groups, dtype)
    plan = lstm_recurrence.plan(h, b)
    before = dict(lstm_recurrence.launches_by_step)
    ys, cs, c_fin = lstm_recurrence.forward(xg, w)
    torch.cuda.synchronize()
    after = lstm_recurrence.launches_by_step
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == plan["step"]) for k in fused_lstm.STEPS}
    if torch.cuda.get_device_properties(0).multi_processor_count == 132:
        assert plan["step"] == step  # the H100's SM count
    p_ys, p_cs = lstm_trajectory_plain(xg, w)
    for name, got, want in (("ys", ys, p_ys), ("cs", cs, p_cs),
                            ("c_fin", c_fin, p_cs[-1])):
        assert got.dtype == dtype and bool(torch.isfinite(got).all()), name
        g, v = got.float(), want.float()
        if dtype == torch.bfloat16:
            assert bool(((g - v).abs() <= _bf16_ulp(v) + 1e-6).all()), name
        elif not bool(((g - v).abs() <= ATOL + RTOL * v.abs()).all()):
            # As chip_smoke.py holds it: the kernel within the tolerance of
            # the exact trajectory where fp32 plain's rounding misses.
            e_ys, e_cs = lstm_trajectory_plain(xg.double(), w.double())
            exact = {"ys": e_ys, "cs": e_cs, "c_fin": e_cs[-1]}[name]
            assert bool(((g.double() - exact).abs()
                         <= ATOL + RTOL * exact.abs()).all()), name


@pytest.mark.cuda
def test_hagcn_calls_take_the_ring_step():
    """HAGCN's three calls a request (H = 60, 120, 60 at B = 5) run the
    ring step, and the counter says so."""
    _card()
    before = dict(lstm_recurrence.launches_by_step)
    for h in (60, 120, 60):
        assert lstm_recurrence.plan(h, 5)["step"] == "ring"
        lstm_recurrence.forward(*_inputs(14 * 100, 5, h, 1, torch.float32))
    torch.cuda.synchronize()
    assert lstm_recurrence.launches_by_step["ring"] - before["ring"] == 3
    assert lstm_recurrence.launches_by_step["classic"] == before["classic"]


@pytest.mark.cuda
def test_an_unaligned_fp32_source_takes_the_classic_step():
    """A view of xg 4 bytes off 16-byte alignment cannot feed the ring's
    bulk copies: the same cut on the classic step, the same answer."""
    _card()
    t, b, h = 20, 5, 60
    xg, w = _inputs(t, b, h, 1, torch.float32)
    flat = torch.empty(xg.numel() + 1, device="cuda")
    odd = flat[1:].view(xg.shape)
    odd.copy_(xg)
    before = dict(lstm_recurrence.launches_by_step)
    ys, cs, _ = lstm_recurrence.forward(odd, w)
    want_ys, want_cs, _ = lstm_recurrence.forward(xg, w)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches_by_step["classic"] - \
        before["classic"] == 1
    torch.testing.assert_close(ys, want_ys, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(cs, want_cs, atol=ATOL, rtol=RTOL)


class _FakePlans:
    """The forward and backward libraries' plan entries: 7 ints, and the
    forward's step as an eighth."""

    def __init__(self, step):
        self.step = step

    def fused_lstm_fwd_plan(self, h, b, addr):
        out = (ctypes.c_int * 8).from_address(addr)
        out[:] = [4, 1, h, 4 * h, 16, 2, 1000, self.step]
        return 0

    def fused_lstm_bwd_plan(self, h, b, addr):
        out = (ctypes.c_int * 7).from_address(addr)
        out[:] = [4, 1, h, 4 * h, 16, 2, 2000]
        return 0


@pytest.mark.parametrize("step", range(len(fused_lstm.STEPS)))
def test_plan_names_the_forward_step(step):
    wrapper = fused_lstm.FusedLstmRecurrence()
    wrapper._fwd = wrapper._bwd = _FakePlans(step)
    fwd = wrapper.plan(60, 5)
    assert fwd["step"] == fused_lstm.STEPS[step]
    assert {k: fwd[k] for k in fused_lstm.PLAN_FIELDS} == dict(
        zip(fused_lstm.PLAN_FIELDS, [4, 1, 60, 240, 16, 2, 1000]))
    bwd = wrapper.plan(60, 5, backward=True)
    assert set(bwd) == set(fused_lstm.PLAN_FIELDS)


def test_the_step_counter_covers_every_design_and_the_cpu_adds_none():
    wrapper = fused_lstm.FusedLstmRecurrence()
    assert wrapper.launches_by_step == {"classic": 0, "ring": 0}
    xg = torch.randn(3, 2, 2, 32, requires_grad=True)
    before = dict(lstm_recurrence.launches_by_step)
    ys, c_fin = lstm_recurrence(xg, torch.randn(2, 8, 32) * 0.1)
    (ys.sum() + c_fin.sum()).backward()
    assert lstm_recurrence.launches_by_step == before


def test_the_stamped_build_is_a_library_of_its_own(tmp_path, monkeypatch):
    """build_variant compiles one source with the macro into its own
    library, once; build_libraries never compiles the macro."""
    runs = []

    class Done:
        returncode, stdout = 0, ""

    def fake_run(cmd, **kwargs):
        runs.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return Done()

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    lib = build.build_variant("fused_lstm", "LSTM_STAMPS")
    assert lib.exists() and lib.name.startswith("fused_lstm_lstm_stamps_")
    assert build.build_variant("fused_lstm", "LSTM_STAMPS") == lib
    assert len(runs) == 1 and "-DLSTM_STAMPS" in runs[0]
    assert runs[0][-1].endswith("fused_lstm.cu")
    assert "-DLSTM_STAMPS" not in build._nvcc_cmd(
        build.CSRC / "fused_lstm.cu", tmp_path / "x.so")
