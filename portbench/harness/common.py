"""What every runner shares: seeds, weights and inputs made from ``--seed``,
the device's name and peak memory, and the comparison's arithmetic."""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np


def sub_seed(seed: int, purpose: str) -> int:
    """A 32-bit seed for one use (``"weights"``, ``"traffic"``, ...) of the
    run's ``--seed``; any whole number is taken, large ones too."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             *purpose.encode()]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint32)[0])


def rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, purpose))


def make_weights(specs: Sequence[tuple], seed: int, device,
                 dtype=None) -> Dict:
    """Every entry of ``specs`` (``(name, shape, bound)`` or ``(name,
    shape, bound, centre)``) uniform in ``±bound``, or in ``centre ±
    bound``, drawn on ``device`` by one generator seeded from ``seed``, in
    one call. A centre shifts its own entry only: every entry's draw is
    the same with or without centres. A BatchNorm's running variance
    draws around 1, its ``num_batches_tracked`` at bound 0."""
    import torch

    dtype = dtype or torch.float32
    total = sum(math.prod(spec[1]) for spec in specs)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    flat = torch.empty(total, dtype=dtype, device=device).uniform_(
        -1.0, 1.0, generator=gen)
    out, off = {}, 0
    for name, shape, bound, *centre in specs:
        size = math.prod(shape)
        out[name] = flat[off:off + size].view(shape) * bound
        if centre:
            out[name] += centre[0]
        off += size
    return out


def make_windows(spec: dict, count: int, gen: np.random.Generator
                 ) -> np.ndarray:
    """``count`` input windows ``(count, channels, length)`` float32 of the
    configuration's ``input`` kind: ``uniform`` in ``[low, high]`` (min-max
    scaled sensors), or ``wear_vibration``, a snapshot ``centre + amp *
    N(0, 1)`` clipped to ``[low, high]`` with its amplitude uniform in
    ``amp`` (a bearing's vibration growing as it wears)."""
    shape = (count, spec["channels"], spec["length"])
    if spec["kind"] == "uniform":
        return gen.uniform(spec["low"], spec["high"], shape).astype(np.float32)
    if spec["kind"] == "wear_vibration":
        amp = gen.uniform(*spec["amp"], (count, 1, 1)).astype(np.float32)
        x = spec["centre"] + amp * gen.standard_normal(shape, np.float32)
        return np.clip(x, spec["low"], spec["high"]).astype(np.float32)
    raise ValueError(f"unknown input kind {spec['kind']!r}")


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile, linearly interpolated (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def device_info(device, chips: int) -> dict:
    """The result's ``device`` entry; peak memory on the fullest card."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def rel_gaps(answers: Sequence[np.ndarray], refs: Sequence[np.ndarray]
             ) -> Tuple[np.ndarray, List[int]]:
    """Each answer's distance from the reference's, over the larger of the
    root mean square of the reference's answers to its request and 1, the
    span of the normalized RUL labels (random weights can put a request's
    answers all near 0, where a share of their own size would swell); and
    the requests whose answers are missing, misshapen or not finite."""
    gaps, bad = [], []
    for j, (a, r) in enumerate(zip(answers, refs)):
        a = np.asarray(a, dtype=np.float64).reshape(-1)
        r = np.asarray(r, dtype=np.float64).reshape(-1)
        if a.shape != r.shape or not np.all(np.isfinite(a)):
            bad.append(j)
            continue
        scale = max(float(np.sqrt(np.mean(r * r))), 1.0)
        gaps.append(np.abs(a - r) / scale)
    return (np.concatenate(gaps) if gaps else np.zeros(0)), bad
