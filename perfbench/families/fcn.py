"""The FCN family: PixelLink detectors whose results are boxes.

A family file (``perfbench/families/<family>.py``, named by a
configuration's ``family``; ``fcn`` where it names none) gives the
harness everything that depends on what the model computes:

* ``make_params(ctx, device)``: the weights, from the configuration's
  ``weight_seed``;
* ``pool(ctx)``: the request pool, from the mix and ``--seed``;
* ``notes(served)``: lines for stderr about the window's results;
* ``check(ctx, params, records, pool, served, failed)``: each number
  compared, with its limit;
* ``passed(checks)``: whether they pass;
* ``FLOORS``: the checks whose limit is a floor (the rest are ceilings);
* ``control(ctx, params, records, pool, bits)``: the control's numbers
  by name, for ``calibrate.py``.

Here they are the plain reference's weights (``plain/fcn.py``), the
synthetic ICDAR-like scenes (``traffic.pool``) and the three-stage check
of ``compare.py`` on what ``taps.py`` kept.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from perfbench import compare, traffic
from perfbench.plain import fcn

FLOORS = ("images_compared",)


def make_params(ctx, device):
    return fcn.make_params(ctx.layers, ctx.config["weight_seed"], device)


def pool(ctx) -> List[np.ndarray]:
    return traffic.pool(ctx.traffic, ctx.seed)


def notes(served) -> Dict[str, str]:
    n_boxes = [len(b) for _, b in served if b is not None]
    if not n_boxes:
        return {}
    return {"components": f"per served image min {min(n_boxes)}, median "
                          f"{float(np.median(n_boxes))}, max {max(n_boxes)}"}


check = compare.check
passed = compare.passed


def control(ctx, params, records, pool, bits: int) -> Dict[str, float]:
    """Stage 1's numbers for the reference at ``bits`` mantissa bits in
    the program's place."""
    return dict(zip(("logit_gap_max", "logit_gap_mean"),
                    compare.control_gaps(ctx, params, records, pool, bits)))
