"""Post-processing: positive pixels joined into connected components (CC)
by positive links; each component is a detected text box (paper §III.A,
PixelLink).

Labels are "component max linear index + 1", reached by max-label
propagation: the one-hop spread along symmetrized positive links and,
with ``hop="log"`` (the default), a pointer jump after each spread
(``labels <- max(labels, labels[labels - 1])``), which converges in
O(log diameter) rounds to the same fixpoint.  The label-map functions
take a leading batch axis or none; every image of a batch keeps its own
round count and convergence flag.

``cc_label_numpy`` is the union-find oracle; ``boxes_from_labels`` is the
host-side box extraction of the serving tail.  The device tail,
:func:`boxes_from_labels_batched_torch`, compacts each converged label
map into a fixed-capacity ``(capacity + 1, 6)`` box tensor on the map's
own device, with no host sync, so the serving tail copies a few hundred
bytes per image instead of the plane; :func:`boxes_from_compact` decodes
those rows into the same box dicts.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime.telemetry import SPANS

# neighbor offsets, PixelLink's 8-connectivity, order: (dy, dx)
NEIGHBORS: Tuple[Tuple[int, int], ...] = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1),           (0, 1),
    (1, -1), (1, 0), (1, 1),
)

CC_HOPS = ("log", "one")


def check_hop(hop: str) -> str:
    if hop not in CC_HOPS:
        raise ValueError(f"unknown hop {hop!r}; expected one of {CC_HOPS}")
    return hop


def link_symmetrize(links: torch.Tensor) -> torch.Tensor:
    """links (..., H, W, 8) -> OR with the reciprocal direction.  The
    reciprocal is read with a wrap-around roll, exactly as the reference
    does, so edge pixels see the opposite edge's links."""
    outs = []
    for d, (dy, dx) in enumerate(NEIGHBORS):
        nb = torch.roll(links[..., 7 - d], shifts=(-dy, -dx), dims=(-2, -1))
        outs.append(torch.maximum(links[..., d], nb))
    return torch.stack(outs, dim=-1)


def cc_init_labels(pos: torch.Tensor) -> torch.Tensor:
    """Each positive pixel holds its linear index + 1 (per image)."""
    H, W = pos.shape[-2:]
    idx = torch.arange(1, H * W + 1, dtype=torch.int32,
                       device=pos.device).reshape(H, W)
    return torch.where(pos, idx, torch.zeros_like(idx))


def _neighbor(labels: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Value of neighbor p + (dy, dx) seen at p; 0 outside the plane."""
    H, W = labels.shape[-2:]
    out = torch.zeros_like(labels)
    out[..., max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)] = \
        labels[..., max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)]
    return out


def cc_spread(labels: torch.Tensor, pos: torch.Tensor, lnk: torch.Tensor
              ) -> torch.Tensor:
    """One hop of max-label propagation across positive links."""
    out = labels
    for d, (dy, dx) in enumerate(NEIGHBORS):
        take = lnk[..., d] & pos
        out = torch.where(take, torch.maximum(out, _neighbor(labels, dy, dx)),
                          out)
    return torch.where(pos, out, torch.zeros_like(out))


def cc_pointer_jump(labels: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``labels <- max(labels, labels[labels - 1])`` within each image."""
    shape = labels.shape
    flat = labels.reshape(-1, shape[-2] * shape[-1])
    idx = torch.clamp(flat - 1, 0, flat.shape[1] - 1).to(torch.int64)
    ptr = torch.gather(flat, 1, idx).reshape(shape)
    return torch.where(pos, torch.maximum(labels, ptr),
                       torch.zeros_like(labels))


def merge_rounds(labels: torch.Tensor, pos: torch.Tensor, lnk: torch.Tensor,
                 max_iters: int, hop: str = "log"):
    """Iterate spread (+ jump) on (N, H, W) maps until every image stops
    changing or has run ``max_iters`` rounds; an image stops updating as
    soon as it converges.  Returns ``(labels, iters, converged)``.

    Each round starts with a host read of the convergence flags, which
    waits for the device: a ``cc.merge`` span with one ``cc.sync`` span
    per read, and the counts ``cc.rounds`` (the largest per-image round
    count) and ``cc.syncs`` (rounds + 1) in ``SPANS``' tally."""
    n = labels.shape[0]
    dev = labels.device
    changed = torch.ones(n, dtype=torch.bool, device=dev)
    iters = torch.zeros(n, dtype=torch.int32, device=dev)
    rounds = 0
    with SPANS.span("cc.merge"):
        while True:
            active = changed & (iters < max_iters)
            with SPANS.span("cc.sync"):
                go = bool(active.any())
            if not go:
                break
            new = cc_spread(labels, pos, lnk)
            if hop == "log":
                new = cc_pointer_jump(new, pos)
            delta = (new != labels).flatten(1).any(dim=1)
            labels = torch.where(active[:, None, None], new, labels)
            changed = torch.where(active, delta, changed)
            iters = iters + active.to(torch.int32)
            rounds += 1
    SPANS.count("cc.rounds", rounds)
    SPANS.count("cc.syncs", rounds + 1)
    return labels, iters, ~changed


def _prepare(score, links, score_thr, link_thr, valid_mask):
    if valid_mask is not None:
        score = torch.where(valid_mask, score, torch.zeros_like(score))
    pos = score > score_thr
    lnk = link_symmetrize(links) > link_thr
    return pos, lnk


def cc_label_batched(score: torch.Tensor, links: torch.Tensor,
                     score_thr: float = 0.5, link_thr: float = 0.5,
                     max_iters: int = 256,
                     valid_mask: Optional[torch.Tensor] = None,
                     hop: str = "log", return_stats: bool = False):
    """(N, H, W) scores + (N, H, W, 8) links -> (N, H, W) int32 labels
    (0 = background).  ``valid_mask`` zeroes scores outside each image's
    valid region.  With ``return_stats``: ``(labels, iters, converged)``
    with per-image (N,) round counts and flags."""
    check_hop(hop)
    pos, lnk = _prepare(score, links, score_thr, link_thr, valid_mask)
    labels, iters, converged = merge_rounds(cc_init_labels(pos), pos, lnk,
                                            max_iters, hop)
    if return_stats:
        return labels, iters, converged
    return labels


def cc_label_stats(score: torch.Tensor, links: torch.Tensor,
                   score_thr: float = 0.5, link_thr: float = 0.5,
                   max_iters: int = 256, hop: str = "log"):
    """One (H, W) image -> ``(labels, iters, converged)``."""
    labels, iters, conv = cc_label_batched(
        score[None], links[None], score_thr, link_thr, max_iters, hop=hop,
        return_stats=True)
    return labels[0], iters[0], conv[0]


def cc_label(score: torch.Tensor, links: torch.Tensor,
             score_thr: float = 0.5, link_thr: float = 0.5,
             max_iters: int = 256, hop: str = "log") -> torch.Tensor:
    """One (H, W) image -> its (H, W) int32 label map (0 = background,
    else the component's max linear index + 1)."""
    return cc_label_stats(score, links, score_thr, link_thr, max_iters,
                          hop)[0]


def cc_label_numpy(score: np.ndarray, links: np.ndarray,
                   score_thr: float = 0.5, link_thr: float = 0.5
                   ) -> np.ndarray:
    """Union-find oracle with identical link semantics."""
    H, W = score.shape
    pos = score > score_thr
    lnk = link_symmetrize(torch.as_tensor(links)).numpy() > link_thr
    parent = np.arange(H * W)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for y in range(H):
        for x in range(W):
            if not pos[y, x]:
                continue
            for d, (dy, dx) in enumerate(NEIGHBORS):
                ny, nx = y + dy, x + dx
                if 0 <= ny < H and 0 <= nx < W and pos[ny, nx] \
                        and lnk[y, x, d]:
                    ra, rb = find(y * W + x), find(ny * W + nx)
                    if ra != rb:
                        parent[max(ra, rb)] = min(ra, rb)
    out = np.zeros((H, W), np.int32)
    for y in range(H):
        for x in range(W):
            if pos[y, x]:
                out[y, x] = find(y * W + x) + 1
    return out


def boxes_from_labels(labels: np.ndarray, min_area: int = 1) -> List[Dict]:
    """Axis-aligned boxes per component, in ascending label order: one
    pass of scatter min/max and a bincount over the positive pixels."""
    labels = np.asarray(labels)
    ys, xs = np.nonzero(labels)
    if ys.size == 0:
        return []
    uniq, inv = np.unique(labels[ys, xs], return_inverse=True)
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
    return [
        {
            "label": int(uniq[i]),
            "box": (int(x0[i]), int(y0[i]), int(x1[i]), int(y1[i])),
            "area": int(area[i]),
        }
        for i in range(k)
        if area[i] >= min_area
    ]


def boxes_from_labels_reference(labels: np.ndarray,
                                min_area: int = 1) -> List[Dict]:
    """Quadratic per-label scan: the parity oracle of
    :func:`boxes_from_labels`."""
    labels = np.asarray(labels)
    out = []
    for lab in np.unique(labels):
        if lab == 0:
            continue
        ys, xs = np.nonzero(labels == lab)
        if ys.size < min_area:
            continue
        out.append({
            "label": int(lab),
            "box": (int(xs.min()), int(ys.min()), int(xs.max()),
                    int(ys.max())),
            "area": int(ys.size),
        })
    return out


#: fill value of unused unique-label slots in the device extraction
#: (larger than any real label: labels are bounded by H*W + 1)
_BOX_FILL = np.iinfo(np.int32).max


def boxes_from_labels_batched_torch(labels: torch.Tensor, capacity: int):
    """(N, H, W) int32 label maps -> ``(rows, counts)``: ``rows`` (N,
    capacity + 1, 6) int32 of ``(label, x0, y0, x1, y1, area)`` and
    ``counts`` (N,) int32, on the labels' device and without a host sync.

    Per image, the ``capacity + 1`` smallest label values form a sorted
    unique list (``sort``, a first-of-run mask, ``cumsum`` to ranks and a
    scatter into a buffer prefilled with ``_BOX_FILL``); slot 0 takes the
    background when there is one.  Each pixel finds its slot by
    ``searchsorted`` and scatter-reduces its coordinates (min, max) and
    its area (sum) into it.  Rows come in ascending label order, unused
    and background slots are all-zero, and a label past the capacity
    contributes nothing.  ``counts`` is the exact number of fixpoint
    representatives (pixels whose label is their own index + 1), so
    ``counts > capacity`` detects an overflow whatever the capacity."""
    n, h, w = labels.shape
    npx = h * w
    seg = capacity + 1
    dev = labels.device
    flat = labels.reshape(n, npx).to(torch.int32)
    srt = torch.sort(flat, dim=1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    rank = torch.cumsum(first.to(torch.int64), dim=1) - 1
    # ranks past the capacity, and every repeat, go to a junk slot
    dst = torch.where(first & (rank < seg), rank, torch.full_like(rank, seg))
    uniq = torch.full((n, seg + 1), _BOX_FILL, dtype=torch.int32, device=dev)
    uniq = uniq.scatter(1, dst, srt)[:, :seg].contiguous()
    slot = torch.clamp(torch.searchsorted(uniq, flat), max=capacity)
    ok = (torch.gather(uniq, 1, slot) == flat) & (flat > 0)
    idx = torch.arange(npx, dtype=torch.int32, device=dev).expand(n, npx)
    ys, xs = idx // w, idx % w
    big = torch.full_like(idx, max(h, w))
    neg = torch.full_like(idx, -1)
    i32 = np.iinfo(np.int32)

    def reduce(src, how, init):
        buf = torch.full((n, seg), init, dtype=torch.int32, device=dev)
        return buf.scatter_reduce(1, slot, src, how, include_self=True)

    x0 = reduce(torch.where(ok, xs, big), "amin", i32.max)
    y0 = reduce(torch.where(ok, ys, big), "amin", i32.max)
    x1 = reduce(torch.where(ok, xs, neg), "amax", i32.min)
    y1 = reduce(torch.where(ok, ys, neg), "amax", i32.min)
    area = reduce(ok.to(torch.int32), "sum", 0)
    lab = torch.where((uniq > 0) & (uniq < _BOX_FILL), uniq,
                      torch.zeros_like(uniq))
    rows = torch.stack([lab, x0, y0, x1, y1, area], dim=-1)
    keep = ((lab > 0) & (area > 0))[..., None]
    rows = torch.where(keep, rows, torch.zeros_like(rows))
    counts = (flat == idx + 1).sum(dim=1, dtype=torch.int32)
    return rows, counts


def boxes_from_labels_torch(labels: torch.Tensor, capacity: int):
    """One (H, W) label map -> ``(rows (capacity + 1, 6), count)``; see
    :func:`boxes_from_labels_batched_torch`."""
    rows, counts = boxes_from_labels_batched_torch(labels[None], capacity)
    return rows[0], counts[0]


def boxes_from_compact(rows: np.ndarray, min_area: int = 1) -> List[Dict]:
    """Compact device rows -> the host box dicts, in the rows' ascending
    label order, so the result equals :func:`boxes_from_labels` on the
    same label map."""
    rows = np.asarray(rows)
    keep = (rows[:, 0] > 0) & (rows[:, 5] >= min_area)
    return [
        {
            "label": int(lab),
            "box": (int(x0), int(y0), int(x1), int(y1)),
            "area": int(area),
        }
        for lab, x0, y0, x1, y1, area in rows[keep]
    ]


def f_measure(pred_boxes: List[Dict],
              gt_boxes: List[Tuple[int, int, int, int]],
              iou_thr: float = 0.5) -> Dict[str, float]:
    """IoU-matched precision, recall and F (the paper's Table VI).  Each
    prediction takes the unmatched ground-truth box of HIGHEST IoU at or
    above the threshold."""
    def iou(a, b):
        ax0, ay0, ax1, ay1 = a
        bx0, by0, bx1, by1 = b
        iw = max(min(ax1, bx1) - max(ax0, bx0) + 1, 0)
        ih = max(min(ay1, by1) - max(ay0, by0) + 1, 0)
        inter = iw * ih
        ua = (ax1 - ax0 + 1) * (ay1 - ay0 + 1)
        ub = (bx1 - bx0 + 1) * (by1 - by0 + 1)
        return inter / max(ua + ub - inter, 1)

    matched, tp = set(), 0
    for pb in pred_boxes:
        best_gi, best_iou = -1, 0.0
        for gi, gb in enumerate(gt_boxes):
            if gi in matched:
                continue
            v = iou(pb["box"], gb)
            if v >= iou_thr and v > best_iou:
                best_gi, best_iou = gi, v
        if best_gi >= 0:
            matched.add(best_gi)
            tp += 1
    prec = tp / max(len(pred_boxes), 1)
    rec = tp / max(len(gt_boxes), 1)
    f = 2 * prec * rec / max(prec + rec, 1e-9)
    return {"precision": prec, "recall": rec, "f_measure": f}
