"""PixelLink's connected components and boxes, by graph search.

A pixel is positive when its score exceeds the score threshold inside the
image's valid region; two 8-neighbours belong together when both are
positive and the link from either side exceeds the link threshold
(PixelLink, arXiv:1801.01315 §3.3).  A component is labelled with its
largest row-major pixel index + 1, the label the program's maps carry;
0 is background.  Components come from SciPy's graph search, not from
label propagation as the program does it.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

# (dy, dx) of the 8 link channels, in the heads' channel order
NEIGHBORS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
             (1, 1))

Box = Tuple[int, int, int, int, int, int]    # label, x0, y0, x1, y1, area


def labels(score: np.ndarray, links: np.ndarray, valid_q: Tuple[int, int],
           score_thr: float, link_thr: float) -> np.ndarray:
    """(H, W) score and (H, W, 8) link probabilities -> (H, W) int32."""
    h, w = score.shape
    pos = np.zeros((h, w), bool)
    vh, vw = valid_q
    pos[:vh, :vw] = score[:vh, :vw] > score_thr
    lnk = links > link_thr
    idx = np.arange(h * w).reshape(h, w)
    src, dst = [], []
    for d, (dy, dx) in enumerate(NEIGHBORS):
        ys = slice(max(-dy, 0), h - max(dy, 0))
        xs = slice(max(-dx, 0), w - max(dx, 0))
        yq = slice(max(dy, 0), h + min(dy, 0))
        xq = slice(max(dx, 0), w + min(dx, 0))
        both = pos[ys, xs] & pos[yq, xq]
        linked = lnk[ys, xs, d] | lnk[yq, xq, 7 - d]
        keep = both & linked
        src.append(idx[ys, xs][keep])
        dst.append(idx[yq, xq][keep])
    src = np.concatenate(src)
    dst = np.concatenate(dst)
    graph = coo_matrix((np.ones(src.size, np.int8), (src, dst)),
                       shape=(h * w, h * w))
    _, comp = connected_components(graph, directed=False)
    top = np.full(comp.max() + 1, -1, np.int64)
    flat = idx.ravel()
    np.maximum.at(top, comp[pos.ravel()], flat[pos.ravel()])
    out = np.where(pos.ravel(), top[comp] + 1, 0)
    return out.reshape(h, w).astype(np.int32)


def boxes(label_map: np.ndarray) -> List[Box]:
    """One row per component, in ascending label order."""
    lab = np.asarray(label_map)
    ys, xs = np.nonzero(lab)
    if ys.size == 0:
        return []
    uniq, inv = np.unique(lab[ys, xs], return_inverse=True)
    k = uniq.size
    x0 = np.full(k, np.iinfo(np.int64).max)
    y0 = np.full(k, np.iinfo(np.int64).max)
    x1 = np.full(k, -1)
    y1 = np.full(k, -1)
    np.minimum.at(x0, inv, xs)
    np.minimum.at(y0, inv, ys)
    np.maximum.at(x1, inv, xs)
    np.maximum.at(y1, inv, ys)
    area = np.bincount(inv, minlength=k)
    return [(int(uniq[i]), int(x0[i]), int(y0[i]), int(x1[i]), int(y1[i]),
             int(area[i])) for i in range(k)]
