"""The comparison that decides ``correct``.

Three stages of what the timed path produced, for every batch slot the
tap kept (``taps.py``), each slot matched to its pool image by the
values at a grid of its input:

1. the FCN forward: the program's logits against the plain reference's
   (``plain/fcn.py``) on the same padded image and the same f32 weights,
   as ``logit_gap_max`` (the largest |difference| over the plane) and
   ``logit_gap_mean`` (its mean), both over L = the reference's largest
   |logit| on that plane, worst image first;
2. the CC labelling: the program's label map against the reference's
   components (``plain/cc.py``) of the program's own score and link
   maps, as ``label_mismatch_px`` (pixels that differ, non-converged
   maps included);
3. the box tail: every served result of a kept image against the boxes
   of the program's label map for it, as ``box_mismatch`` (results that
   differ).

Stages 2 and 3 follow the program from its own maps: thresholded maps
have no tolerance, so a map one rounding away from the reference's could
flip a pixel.  Stage 1 checks the maps they start from.  Besides:
``failed_requests`` (requests that errored or never came back) and
``images_compared`` (at least one).

The control is the reference at the nearest precision below the
configuration's, put in the program's place: its logits against the
reference's by stage 1's numbers (:func:`control_gaps`).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from perfbench.plain import cc, fcn
from perfbench.taps import STRIDE

Box = Tuple[int, int, int, int, int, int]


def _padded(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    out = np.zeros((hw[0], hw[1], 3), np.float32)
    out[:img.shape[0], :img.shape[1]] = img
    return out


def _plane(rec) -> Tuple[int, int]:
    """The bucket plane of a kept call: its maps are at a quarter."""
    return rec["logits"].shape[1] * 4, rec["logits"].shape[2] * 4


def identify(records: List[Dict[str, np.ndarray]],
             pool: Sequence[np.ndarray]
             ) -> Tuple[List[Tuple[int, int, int]], int]:
    """(record, slot, pool index) of every kept batch slot that holds a
    pool image, and the number of live slots that match none; padding
    slots (valid size 0) are skipped."""
    out, lost = [], 0
    for r, rec in enumerate(records):
        fp = rec["fp"]
        plane = _plane(rec)
        cands = {}
        for j, img in enumerate(pool):
            if img.shape[0] <= plane[0] and img.shape[1] <= plane[1]:
                cands[j] = _padded(img, plane)[::STRIDE, ::STRIDE]
        for i in range(fp.shape[0]):
            if not rec["valid_q"][i].any():
                continue
            hit = [j for j, c in cands.items() if c.shape == fp[i].shape
                   and np.array_equal(c, fp[i])]
            if hit:
                out.append((r, i, hit[0]))
            else:
                lost += 1
    return out, lost


def reference_logits(ctx, params, img: np.ndarray, plane, bits: int
                     ) -> torch.Tensor:
    bfp = ctx.config["bfp"]
    x = torch.from_numpy(_padded(img, plane))[None].to(ctx.device)
    logits, _ = fcn.forward(ctx.layers, params, x,
                            block_size=bfp["block_size"],
                            mantissa_bits=bits, rounding=bfp["rounding"])
    return logits[0]


def _gaps(got: torch.Tensor, want: torch.Tensor) -> Tuple[float, float]:
    d = (got.to(torch.float32) - want).abs()
    scale = float(want.abs().max().clamp_min(1e-30))
    return float(d.max()) / scale, float(d.mean()) / scale


def check(ctx, params, records, pool, served: Iterable[Tuple[int, Optional[
          List[Box]]]], failed: int) -> Dict[str, Dict[str, float]]:
    """The cell's numbers, each with its limit (``images_compared`` is a
    floor, the others are ceilings)."""
    cfg = ctx.config
    found, lost = identify(records, pool)
    gmax = gmean = 0.0
    label_px = 0
    expect: Dict[int, List[Box]] = {}
    refs: Dict[Tuple[int, Tuple[int, int]], torch.Tensor] = {}
    for r, i, j in found:
        rec = records[r]
        plane = _plane(rec)
        if (j, plane) not in refs:
            refs[j, plane] = reference_logits(
                ctx, params, pool[j], plane, cfg["bfp"]["mantissa_bits"])
        want = refs[j, plane]
        a, b = _gaps(torch.from_numpy(rec["logits"][i]).to(want.device),
                     want)
        gmax, gmean = max(gmax, a), max(gmean, b)
        ref = cc.labels(rec["score"][i], rec["links"][i],
                        tuple(int(v) for v in rec["valid_q"][i]),
                        cfg["score_thr"], cfg["link_thr"])
        label_px += int(np.count_nonzero(ref != rec["labels"][i]))
        if not rec["converged"][i]:
            label_px += 1
        expect.setdefault(j, cc.boxes(rec["labels"][i]))
    box_bad = sum(1 for j, got in served
                  if j in expect and got is not None and got != expect[j])
    lim = ctx.cell["limits"]
    return {
        "logit_gap_max": {"value": gmax, "limit": lim["logit_gap_max"]},
        "logit_gap_mean": {"value": gmean, "limit": lim["logit_gap_mean"]},
        "label_mismatch_px": {"value": label_px, "limit": 0},
        "box_mismatch": {"value": box_bad, "limit": 0},
        "failed_requests": {"value": failed, "limit": 0},
        "unmatched_slots": {"value": lost, "limit": 0},
        "images_compared": {"value": len(found), "limit": 1},
    }


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    ok = all(v["value"] <= v["limit"] for k, v in checks.items()
             if k != "images_compared")
    return ok and checks["images_compared"]["value"] >= \
        checks["images_compared"]["limit"]


def control_gaps(ctx, params, records, pool, bits: int) -> Tuple[float,
                                                                  float]:
    """Stage 1's numbers for the reference at ``bits`` mantissa bits in
    the program's place, on the same kept images."""
    gmax = gmean = 0.0
    seen = set()
    for r, i, j in identify(records, pool)[0]:
        rec = records[r]
        plane = _plane(rec)
        if (j, plane) in seen:
            continue
        seen.add((j, plane))
        want = reference_logits(ctx, params, pool[j], plane,
                                ctx.config["bfp"]["mantissa_bits"])
        got = reference_logits(ctx, params, pool[j], plane, bits)
        a, b = _gaps(got, want)
        gmax, gmean = max(gmax, a), max(gmean, b)
    return gmax, gmean
