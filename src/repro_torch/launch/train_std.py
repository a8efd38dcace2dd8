"""End-to-end STD training: a reduced PixelLink model on synthetic
scene-text images until the box f-measure on held-out images improves.

The paper's task end to end: U-FCN -> score and link maps -> connected
components -> box f-measure.  Training runs the reference datapath
(``mode="reference"``, f32 storage): the kernels have no backward.  The
trained parameters deploy through ``normalize_weights`` (BN folding)
into the optimized datapath.

    python -m repro_torch.launch.train_std --steps 150
    python -m repro_torch.launch.train_std --device cpu --width 0.125
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.data.images import SyntheticSTDData
from repro_torch.models.fcn import PixelLinkModel, STDLoss
from repro_torch.models.fcn import postprocess
from repro_torch.models.fcn.pixellink import STDConfig
from repro_torch.optim import adamw, cosine_with_warmup, value_and_grad

SEED = 0


def make_config(width: float = 0.25, size: int = 64,
                merge_ch: Tuple[int, int, int] = (16, 16, 8)) -> STDConfig:
    """The training configuration: VGG-16 PixelLink in the reference
    datapath with f32 storage."""
    return STDConfig(backbone="vgg16", width=width, image_size=(size, size),
                     merge_ch=tuple(merge_ch), mode="reference",
                     storage_fp16=False)


def make_train_step(model, loss_fn, opt_update):
    """``step((params, opt), batch) -> ((params, opt), losses)``, the
    ``TrainRunner`` step: the loss, its gradient by autograd (zeros for
    the leaves the forward does not read) and one optimizer update."""
    def step(state, batch):
        params, opt = state

        def loss(p):
            d = loss_fn(model.apply(p, batch["images"]), batch["score"],
                        batch["links"])
            return d["loss"], d

        (_, d), g = value_and_grad(loss, params, has_aux=True)
        params, opt = opt_update(g, opt, params)
        return (params, opt), d

    return step


def batch_on(sample: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A ``SyntheticSTDData`` sample's maps as tensors on ``device``."""
    return {k: torch.from_numpy(sample[k]).to(device)
            for k in ("images", "score", "links")}


@torch.no_grad()
def evaluate(model, params, data, n: int = 4,
             score_thr: float = 0.6) -> float:
    """Mean f-measure (IoU 0.3) over ``n`` held-out images: single-image
    CC labels, then boxes on the host."""
    fms = []
    for i in range(n):
        s = data.sample(1000 + i, 1)
        out = model.apply(params, torch.from_numpy(s["images"]))
        labels = postprocess.cc_label(out["score"][0], out["links"][0],
                                      score_thr=score_thr)
        boxes = postprocess.boxes_from_labels(labels.cpu().numpy(),
                                              min_area=4)
        fm = postprocess.f_measure(boxes, s["boxes"][0], iou_thr=0.3)
        fms.append(fm["f_measure"])
    return float(np.mean(fms))


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(
        description="Train a reduced PixelLink on synthetic images and "
                    "check that the held-out f-measure improves.")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = PixelLinkModel(make_config(args.width, args.size), args.device)
    params = model.init_params(torch.Generator().manual_seed(SEED))
    data = SyntheticSTDData((args.size, args.size), max_instances=3,
                            seed=SEED)
    opt_init, opt_update = adamw(
        cosine_with_warmup(3e-3, 10, args.steps), weight_decay=1e-4)
    state = (params, opt_init(params))
    step = make_train_step(model, STDLoss(neg_ratio=3.0), opt_update)

    f0 = evaluate(model, params, data)
    print(f"[train_std] before training: f-measure {f0:.3f}")
    t0 = time.time()
    for i in range(args.steps):
        state, d = step(state, batch_on(data.sample(i, args.batch),
                                        model.device))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"[train_std] step {i:4d} loss {float(d['loss']):.4f} "
                  f"(score {float(d['score_loss']):.4f} "
                  f"link {float(d['link_loss']):.4f})")
    f1 = evaluate(model, state[0], data)
    print(f"[train_std] after {args.steps} steps ({time.time() - t0:.0f}s): "
          f"f-measure {f0:.3f} -> {f1:.3f}")
    if not f1 > f0:
        raise RuntimeError(f"training must improve the f-measure: "
                           f"{f0:.3f} -> {f1:.3f}")
    print("train_std OK")
    return {"f_before": f0, "f_after": f1}


if __name__ == "__main__":
    main()
