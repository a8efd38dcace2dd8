"""Inputs of the tile-local CC spread (K3) that stress its function: each
case is ``(labels, pos, lnk)``, int32 NumPy arrays of shapes (N, H, W),
(N, H, W) and (N, H, W, 8), with H and W multiples of the tile.

- ``asymmetric``: random positive pixels and random links that are not
  symmetrized, so a link p -> q may have no q -> p.
- ``dirty``: random labels, negative ones included, on every pixel, the
  non-positive ones too: the first spread round reads them before it
  zeroes those pixels, and a positive pixel linked out of the tile takes
  the max with 0.
- ``serpentine``: in every tile one component that winds through all its
  rows (the even rows, joined at alternate ends), so the Jacobi loop runs
  about half the tile's pixel count in rounds.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

Case = Tuple[np.ndarray, np.ndarray, np.ndarray]
CASES = ("asymmetric", "dirty", "serpentine")


def init_labels(pos: np.ndarray) -> np.ndarray:
    """Each positive pixel holds its linear index + 1 within its image."""
    h, w = pos.shape[-2:]
    idx = np.arange(1, h * w + 1, dtype=np.int32).reshape(h, w)
    return np.where(pos, idx, 0).astype(np.int32)


def serpentine_tile(th: int, tw: int) -> np.ndarray:
    """(th, tw) bool: the even rows, joined by row r + 1 at the last
    column where r % 4 == 0 and at the first column otherwise."""
    pos = np.zeros((th, tw), bool)
    pos[::2] = True
    for r in range(1, th, 2):
        pos[r, tw - 1 if r % 4 == 1 else 0] = True
    return pos


def make_case(name: str, seed: int, n: int, h: int, w: int, th: int,
              tw: int) -> Case:
    rng = np.random.default_rng(seed)
    if name == "serpentine":
        pos = np.tile(serpentine_tile(th, tw), (n, h // th, w // tw))
        lnk = np.ones((n, h, w, 8), np.int32)
        labels = init_labels(pos)
    elif name in ("asymmetric", "dirty"):
        pos = rng.uniform(size=(n, h, w)) < 0.6
        lnk = (rng.uniform(size=(n, h, w, 8)) < 0.5).astype(np.int32)
        if name == "dirty":
            labels = rng.integers(-h * w, h * w, (n, h, w)).astype(np.int32)
        else:
            labels = init_labels(pos)
    else:
        raise ValueError(f"unknown case {name!r}; expected one of {CASES}")
    return labels, pos.astype(np.int32), lnk
