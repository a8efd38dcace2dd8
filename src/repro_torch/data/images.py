"""Synthetic STD data: images with rectangular "text instances" plus
pixel-level score/link ground truth at 1/4 scale (the PixelLink label
format).  Random-size generation exercises the paper's §IV.B random-size
path (bucketed batching + the transpose trick)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.models.fcn.postprocess import NEIGHBORS


def _render_instance(img, score, inst, x0, y0, x1, y1, label, rng):
    # "text" = bright strip with character-ish ticks on dark background
    img[y0:y1, x0:x1] += rng.uniform(0.5, 0.9)
    for cx in range(x0, x1, max((x1 - x0) // 6, 2)):
        img[y0:y1, cx:cx + 1] -= 0.3
    sy0, sy1 = y0 // 4, max(y1 // 4, y0 // 4 + 1)
    sx0, sx1 = x0 // 4, max(x1 // 4, x0 // 4 + 1)
    score[sy0:sy1, sx0:sx1] = 1.0
    inst[sy0:sy1, sx0:sx1] = label


def links_from_instances(inst: np.ndarray) -> np.ndarray:
    """GT links: positive where the 8-neighbor has the same instance id."""
    H, W = inst.shape
    links = np.zeros((H, W, 8), np.float32)
    for d, (dy, dx) in enumerate(NEIGHBORS):
        shifted = np.zeros_like(inst)
        ys = slice(max(dy, 0), H + min(dy, 0))
        yd = slice(max(-dy, 0), H + min(-dy, 0))
        xs = slice(max(dx, 0), W + min(dx, 0))
        xd = slice(max(-dx, 0), W + min(-dx, 0))
        shifted[yd, xd] = inst[ys, xs]
        links[..., d] = ((inst > 0) & (shifted == inst)).astype(np.float32)
    return links


class SyntheticSTDData:
    """Batch generator for the STD examples/benchmarks."""

    def __init__(self, image_size: Tuple[int, int] = (512, 512),
                 max_instances: int = 6, seed: int = 0):
        self.image_size = image_size
        self.max_instances = max_instances
        self.seed = seed

    def sample(self, step: int, batch: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step])
        )
        H, W = self.image_size
        imgs = np.zeros((batch, H, W, 3), np.float32)
        scores = np.zeros((batch, H // 4, W // 4), np.float32)
        links = np.zeros((batch, H // 4, W // 4, 8), np.float32)
        boxes: List[List[Tuple[int, int, int, int]]] = []
        for b in range(batch):
            base = rng.uniform(0.0, 0.25, size=(H, W, 1)).astype(np.float32)
            img = np.repeat(base, 3, axis=2)
            score = np.zeros((H // 4, W // 4), np.float32)
            inst = np.zeros((H // 4, W // 4), np.int32)
            bl = []
            n = rng.integers(1, self.max_instances + 1)
            for k in range(n):
                w = int(rng.integers(40, max(W // 3, 48)))
                h = int(rng.integers(12, max(H // 8, 16)))
                x0 = int(rng.integers(0, max(W - w, 1)))
                y0 = int(rng.integers(0, max(H - h, 1)))
                mono = img[..., 0]
                _render_instance(mono, score, inst, x0, y0, x0 + w, y0 + h,
                                 k + 1, rng)
                img = np.repeat(mono[..., None], 3, axis=2)
                bl.append((x0 // 4, y0 // 4, (x0 + w) // 4, (y0 + h) // 4))
            img += rng.normal(0, 0.02, size=img.shape)
            imgs[b] = np.clip(img, 0, 1)
            scores[b] = score
            links[b] = links_from_instances(inst)
            boxes.append(bl)
        return {"images": imgs, "score": scores, "links": links,
                "boxes": boxes}

    def sample_random_size(self, step: int) -> Dict[str, np.ndarray]:
        """Random-size single image (serving path, paper §IV.B)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 777])
        )
        h = int(rng.integers(16, 128)) * 8
        w = int(rng.integers(16, 128)) * 8
        gen = SyntheticSTDData((h, w), self.max_instances,
                               seed=self.seed + step)
        return gen.sample(0, 1)


class RequestStream:
    """Seeded mixed-resolution request stream for the serving benchmarks:
    ``n`` images with sizes drawn from ``hw_range`` (multiples of
    ``step_px`` so the 1/4-scale label maps stay integral), a fraction of
    over-wide images for the §IV.B transpose trick, and ground-truth box
    counts for sanity checks.  Iterating yields
    ``{"image", "hw", "boxes"}`` dicts; ``images()`` returns just the
    image list."""

    def __init__(self, n: int, seed: int = 0,
                 hw_range: Tuple[Tuple[int, int], Tuple[int, int]] =
                 ((48, 128), (48, 128)),
                 step_px: int = 8, over_wide_frac: float = 0.0,
                 over_wide_w: int = 0, max_instances: int = 4):
        self.n = n
        self.seed = seed
        self.hw_range = hw_range
        self.step_px = step_px
        self.over_wide_frac = over_wide_frac
        self.over_wide_w = over_wide_w
        self.max_instances = max_instances

    def __iter__(self):
        (h0, h1), (w0, w1) = self.hw_range
        for i in range(self.n):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, i, 4242])
            )
            h = int(rng.integers(h0 // self.step_px,
                                 h1 // self.step_px + 1)) * self.step_px
            if (self.over_wide_frac > 0
                    and rng.random() < self.over_wide_frac):
                w = self.over_wide_w
            else:
                w = int(rng.integers(w0 // self.step_px,
                                     w1 // self.step_px + 1)) * self.step_px
            sample = SyntheticSTDData(
                (h, w), self.max_instances, seed=self.seed + i
            ).sample(0, 1)
            yield {"image": sample["images"][0], "hw": (h, w),
                   "boxes": sample["boxes"][0]}

    def images(self) -> List[np.ndarray]:
        return [r["image"] for r in self]
