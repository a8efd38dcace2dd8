"""The check fails what it must: the control (the reference at int8 BFP,
7-bit mantissas, in the program's place) and faults planted in the timed
path, while the program itself passes."""
import contextlib
import io
import json

import pytest
import torch

from conftest import REPO, TINY_LIMITS, run_cell


def calibrate_lines(root, workload, seeds, seconds, device):
    from perfbench import calibrate

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        calibrate.main(["--workload", workload, "--seeds", *map(str, seeds),
                        "--control-seeds", str(len(seeds)), "--seconds",
                        str(seconds)], root=root, device=device)
    return [json.loads(ln) for ln in out.getvalue().splitlines()]


def assert_separates(lines, limits):
    for ln in lines:
        assert all(v["value"] <= v["limit"] for k, v in ln["checks"].items()
                   if k != "images_compared"), ln
        assert any(ln["control"][k] > limits[k] for k in limits), ln


def test_control_fails_the_tiny_cells_limits(tiny_root):
    lines = calibrate_lines(tiny_root, "tiny-bulk", [11, 12, 13], 1.0, "cpu")
    assert_separates(lines, TINY_LIMITS)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["vgg16-serve-poisson",
                                      "resnet50-bulk-768p"])
def test_control_fails_each_cells_limits_on_the_card(cuda, workload):
    limits = json.loads((REPO / "perfbench" / "workloads" /
                         f"{workload}.json").read_text())["limits"]
    lines = calibrate_lines(REPO, workload, [21, 22, 23], 3.0, "cuda")
    assert_separates(lines, limits)


def _bump_first_box(fn):
    def bumped(labels, capacity):
        rows, counts = fn(labels, capacity)
        rows = rows.clone()
        live = (rows[0, :, 0] > 0).nonzero()
        if len(live):
            rows[0, live[0, 0], 3] += 1
        return rows, counts
    return bumped


def _flip_a_label(fn):
    def flipped(score, links, *a, **kw):
        out = fn(score, links, *a, **kw)
        labels = out[0].clone()
        labels[:, 0, 0] = labels[:, 0, 0] + 7
        return (labels,) + tuple(out[1:])
    return flipped


def _half_batch(apply):
    def half(self, params, images, **kw):
        n = images.shape[0] // 2
        if n:
            images = torch.cat([images[:n], images[:n],
                                images[2 * n:]])[:images.shape[0]]
        return apply(self, params, images, **kw)
    return half


def _coarse_bfp(rt):
    def coarse(self, x, axis):
        from repro_torch.core import bfp

        return bfp.roundtrip(x.float(), block_size=self.bfp.block_size,
                             mantissa_bits=self.bfp.mantissa_bits - 3,
                             axis=axis)
    return coarse


@pytest.mark.parametrize("fault,cell,number", [
    ("box_row", "tiny-serve-open", "box_mismatch"),
    ("label", "tiny-serve-closed", "label_mismatch_px"),
    ("half_batch", "tiny-bulk", "logit_gap_max"),
    ("coarse_bfp", "tiny-serve-closed", "logit_gap_mean"),
])
def test_planted_faults_come_out_incorrect(tiny_root, monkeypatch, fault,
                                           cell, number):
    from repro_torch.core.interpreter import FCNEngine
    from repro_torch.models.fcn import DetectionModel
    from repro_torch.models.fcn import postprocess as pp

    if fault == "box_row":
        monkeypatch.setattr(pp, "boxes_from_labels_batched_torch",
                            _bump_first_box(
                                pp.boxes_from_labels_batched_torch))
    elif fault == "label":
        monkeypatch.setattr(pp, "cc_label_batched",
                            _flip_a_label(pp.cc_label_batched))
    elif fault == "half_batch":
        monkeypatch.setattr(DetectionModel, "apply",
                            _half_batch(DetectionModel.apply))
    else:
        monkeypatch.setattr(FCNEngine, "_bfp_roundtrip",
                            _coarse_bfp(FCNEngine._bfp_roundtrip))
    rc, out, err = run_cell(tiny_root, cell, seed=7)
    assert rc == 0, err
    assert out["correct"] is False
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]
