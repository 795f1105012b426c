"""5 Adam steps of the port's six bearing models without a kernel
(gnn_rul_tpu_torch/models/) against the JAX package's on the CPU at
PHM2012/Condition_1 full width, by the shared checks of
tests/test_torch_model_checks.py: the losses, every parameter and the
BatchNorm running statistics."""

import pytest

import test_torch_model_checks as checks

# The fewest rows any BatchNorm of a model normalizes at STEP_ROWS:
# HierCorrPool_bearing's encoder runs over its 80 patches, and its third
# block sees 23 steps a window (80 -> conv 81 -> pool 41 -> conv 42 ->
# pool 22 -> conv 23); ST_GCN's TCNs normalize 10 channels over its 40
# patches.
BN_ROWS = {"HierCorrPool_bearing": 4 * 23, "ST_GCN": 4 * 40}


# The flax modules outside each loss: STNet's node scorer ``cnn`` feeds
# only the step function ``score > 0.7``, so no gradient reaches it; torch's
# Adam (the port's, the reference's) leaves it, the JAX package's moves it
# by the weight decay (as RGCNU's unused head, ROADMAP.md Queue 3 entry 5).
UNUSED = {"STNet": ("cnn",)}


@pytest.mark.parametrize("method", checks.NO_KERNEL_BEARING)
def test_five_adam_steps_match_jax(method, monkeypatch):
    """Dropout (ST_GCN's 0.2, HierCorrPool_bearing's 0.35) off on both
    sides; STNet's reconstruction loss at weight 1 on both, its node masks
    and SAGCN's and AGCN_TF's frequency bins the JAX package's. Every
    trajectory holds against JAX's fp32 directly."""
    loss_ref, param_ref, moved = checks.check_trajectory(
        method, monkeypatch, unused=UNUSED.get(method, ()),
        bn_rows=BN_ROWS.get(method))
    assert (loss_ref, param_ref) == ("jax", "jax")
    if method in UNUSED:
        assert moved > 1e-3  # the JAX optimizer moved the scorer
