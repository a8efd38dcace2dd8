"""The one traffic generator every cell's mix is read by.

Images are synthetic scenes of text-like strips, a frozen copy of
``src/repro_torch/data/images.py`` (``SyntheticSTDData.sample`` and
``_render_instance``, image part only: the ground truth is not needed),
drawn from the run's seed.

So that seeds change the order of the work and not its amount, every
seed gets the same multiset of image sizes, of strip counts and of
inter-arrival gaps: sizes and counts are drawn once from a fixed seed,
arrival gaps are the quantiles of the exponential distribution at the
mix's rate, and the run's seed shuffles them and draws the pixels.

A mix (``perfbench/traffic/<name>.json``) gives ``driver`` and its
parameters, and ``source``, the public data its numbers come from; this
module reads ``sizes`` (``[[h0, h1], [w0, w1]]`` in steps of
``step_px``, drawn uniformly and independently), ``pool`` (distinct
images per run), ``instances_mean`` (strips per image, Poisson) and, for
an open loop, ``rate_per_s``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

LAYOUT_SEED = 20240601     # fixes the multiset of sizes and counts


def _render_instance(img, x0, y0, x1, y1, rng):
    img[y0:y1, x0:x1] += rng.uniform(0.5, 0.9)
    for cx in range(x0, x1, max((x1 - x0) // 6, 2)):
        img[y0:y1, cx:cx + 1] -= 0.3


def image(h: int, w: int, instances: int, rng) -> np.ndarray:
    """One (h, w, 3) float32 scene in [0, 1] with ``instances`` strips."""
    mono = rng.uniform(0.0, 0.25, size=(h, w)).astype(np.float32)
    for _ in range(int(instances)):
        bw = int(rng.integers(40, max(w // 3, 48)))
        bh = int(rng.integers(12, max(h // 8, 16)))
        x0 = int(rng.integers(0, max(w - bw, 1)))
        y0 = int(rng.integers(0, max(h - bh, 1)))
        _render_instance(mono, x0, y0, x0 + bw, y0 + bh, rng)
    img = np.repeat(mono[..., None], 3, axis=2)
    img += rng.normal(0, 0.02, size=img.shape).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


def layout(mix: Dict, n: int) -> List[Tuple[int, int, int]]:
    """The mix's ``n`` (height, width, strips), the same for every
    seed."""
    (h0, h1), (w0, w1) = mix["sizes"]
    step = int(mix.get("step_px", 8))
    rng = np.random.default_rng(LAYOUT_SEED)
    hw = [(int(rng.integers(h0 // step, h1 // step + 1)) * step,
           int(rng.integers(w0 // step, w1 // step + 1)) * step)
          for _ in range(n)]
    k = rng.poisson(float(mix["instances_mean"]), size=n)
    return [(h, w, int(c)) for (h, w), c in zip(hw, k)]


def pool(mix: Dict, seed: int) -> List[np.ndarray]:
    """``mix["pool"]`` distinct images: the fixed layout in the seed's
    order, the seed's pixels."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 1]))
    lay = layout(mix, int(mix["pool"]))
    order = rng.permutation(len(lay))
    return [image(*lay[i], rng) for i in order]


def request_order(mix: Dict, seed: int, n: int) -> np.ndarray:
    """Pool index of each of ``n`` requests: whole passes over the pool,
    each in its own seeded order."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 2]))
    p = int(mix["pool"])
    passes = [rng.permutation(p) for _ in range(-(-n // p))]
    return np.concatenate(passes)[:n]


def arrivals(mix: Dict, seed: int, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of an open loop at
    ``rate_per_s``: n = rate x seconds requests, whose gaps are the
    exponential distribution's quantiles (i + 1/2) / n scaled to fill the
    window exactly, in the seed's order.  The first is due at 0."""
    n = max(int(round(float(mix["rate_per_s"]) * seconds)), 1)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    gaps *= seconds / gaps.sum()
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 3]))
    gaps = rng.permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])
