"""On the card: the control, the reference put in the program's place at
float32 with TF32 on (the precision next below the configurations'
float32 with TF32 off), fails the check, and the program passes it, at a
short window of requests of 100-300 windows. ``portbench/calibrate.py``
reads the same at the cells' own sizes."""

import dataclasses

import pytest
import torch

from portbench.harness import serve
from portbench.harness.cell import load

SERVING = ["hagcn-fd001.serve", "logo_bearing-phm2012.serve",
           "fc_stgnn-fd003.serve"]


def _exceeds(nums, limits):
    """Whether any gap the configuration compares exceeds its limit."""
    return any(not nums[name] <= limit for name, limit in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 9, 2 ** 34 + 1])
@pytest.mark.parametrize("workload", SERVING)
def test_the_control_fails_and_the_program_passes(card, workload, seed):
    cell = load(workload)
    cell = dataclasses.replace(cell, traffic={
        **cell.traffic, "sizes": [100, 200, 300],
        "check_requests": 3})
    limits = cell.config["check"]
    model, weights, pool, sizes, offsets, _ = serve.prepare(cell, seed, card)
    answers, _, _ = serve.window(model, pool, sizes, offsets, 0.5, False)
    done = sizes[:len(answers)]
    picks = serve.sample(seed, done, 3)
    refs = serve.reference_answers(cell, weights, pool, done, offsets, picks,
                                   card)
    program = serve.gap_numbers([answers[j] for j in picks], refs)
    assert not _exceeds(program, limits), program
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        ctl = serve.reference_answers(cell, weights, pool, done, offsets,
                                      picks, card, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    control = serve.gap_numbers(ctl, refs)
    assert _exceeds(control, limits), control
