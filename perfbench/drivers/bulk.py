"""Drive the engine path the service uses, as an offline job does.

``EngineFactory(make_model).plan_fn(image, batch, SingleDevice(), "bfp")``
(``repro_torch.runtime.executor``) runs the FCN forward and the CC tail;
``boxes_fn(image, batch, capacity)`` compacts each label map into box
rows on the device; the rows and counts are copied to the host and
decoded into each image's boxes by the program's own readers, as
``STDService`` does: ``postprocess.boxes_from_compact`` for the rows and,
for an image whose components overflow ``boxes_capacity``, the service's
fallback, ``postprocess.boxes_from_labels`` on its label map copied to
the host.  A closed loop of back-to-back batches of ``batch`` distinct
images of the seeded pool, each batch copied host to device from pinned
memory; every step ends with the batch's boxes on the host.

``make_model`` is the harness's: the configuration's ``STDConfig`` and
``BFPConfig`` as its file states them, with the PixelLink head.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from perfbench.harness import Window
from perfbench.taps import Tap

MODEL = "pixellink"


class Driver:
    def __init__(self, ctx, params, pool):
        from repro_torch.core import BFPConfig
        from repro_torch.models.fcn import (DetectionModel, STDConfig,
                                            build_head)
        from repro_torch.models.fcn import postprocess
        from repro_torch.runtime.executor import EngineFactory, SingleDevice

        cfg, mix = ctx.config, ctx.traffic
        self.hw = tuple(pool[0].shape[:2])
        self.b = int(mix["batch"])
        self.cap = int(mix["boxes_capacity"])
        if len(pool) % self.b or any(im.shape[:2] != self.hw for im in pool):
            raise ValueError("the pool must hold whole batches of one size")

        def make_model(hw, precision, model):
            return DetectionModel(STDConfig(
                name=cfg["name"], backbone=cfg["backbone"],
                width=cfg["width"], image_size=tuple(hw),
                merge_ch=tuple(cfg["merge_ch"]),
                upsample_mode=cfg["upsample_mode"], mode=cfg["mode"],
                bfp=BFPConfig(**cfg["bfp"]),
                storage_fp16=cfg["storage_fp16"],
                use_kernels=cfg["use_kernels"], memplan=cfg["memplan"]),
                build_head(model, score_thr=cfg["score_thr"],
                           link_thr=cfg["link_thr"]), ctx.device)

        self.ctx = ctx
        self.pp = postprocess
        self.factory = EngineFactory(make_model, score_thr=cfg["score_thr"],
                                     link_thr=cfg["link_thr"],
                                     device=ctx.device)
        self.dev = self.factory.device
        self.factory.set_params(params, MODEL)
        self.fn = self.factory.plan_fn(self.hw, self.b, SingleDevice(),
                                       "bfp", MODEL)
        self.boxes = self.factory.boxes_fn(self.hw, self.b, self.cap)
        self.params = self.factory.params(self.hw, "bfp", MODEL)
        host = torch.from_numpy(np.stack(pool))
        self.pool = host.pin_memory() if self.dev.type == "cuda" else host
        self.vq = torch.tensor([[self.hw[0] // 4, self.hw[1] // 4]] * self.b,
                               dtype=torch.int32, device=self.dev)
        self.tap = Tap(self.factory, [self.factory.model(self.hw, "bfp",
                                                         MODEL)],
                       int(ctx.cell["sample_calls"]), ctx.seed)
        self._step(0)
        self._sync()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _step(self, k: int):
        """Batch ``k``: the pool index of its first image, each image's
        boxes as ``(label, x0, y0, x1, y1, area)`` rows, and how many
        images took the overflow fallback."""
        s = (k * self.b) % len(self.pool)
        with torch.profiler.record_function("bench.h2d"):
            x = self.pool[s:s + self.b].to(self.dev, non_blocking=True)
        with torch.profiler.record_function("bench.engine"):
            labels, _ = self.fn(self.params, x, self.vq)
        with torch.profiler.record_function("bench.boxes"):
            rows, counts = self.boxes(labels)
        with torch.profiler.record_function("bench.to_host"):
            rows, counts = rows.cpu().numpy(), counts.cpu().numpy()
        with torch.profiler.record_function("bench.decode"):
            out, over = [], 0
            for i in range(self.b):
                if counts[i] > self.cap:
                    over += 1
                    got = self.pp.boxes_from_labels(labels[i].cpu().numpy())
                else:
                    got = self.pp.boxes_from_compact(rows[i])
                out.append([(b["label"], *b["box"], b["area"]) for b in got])
        return s, out, over

    def window(self, seconds: float, tracer) -> Window:
        self.tap.arm()
        out = []
        t0 = time.perf_counter()
        end = t0 + seconds
        tracer.plan(t0, seconds)
        in_slice = 0
        k = 0
        while True:
            now = time.perf_counter()
            if now >= end:
                break
            # every batch ends on the host, so the slice holds whole ones
            tracer.tick(now)
            in_slice += tracer.active
            out.append(self._step(k))
            k += 1
        t1 = time.perf_counter()
        tracer.finish()
        self.tap.disarm()
        served: List = []
        overflow = 0
        for s, boxes, over in out:
            served.extend((s + i, b) for i, b in enumerate(boxes))
            overflow += over
        n = k * self.b
        return Window(attempted=n, failed=0, served=served, seconds=t1 - t0,
                      images=n, batches=k,
                      stats={"forwards_in_slice": in_slice * self.b,
                             "forward_hw": self.hw},
                      notes={"bulk": f"{k} batches of {self.b} in "
                                     f"{t1 - t0:.3f} s; {overflow} images "
                                     f"overflowed {self.cap} boxes"})

    def close(self) -> None:
        del self.fn, self.boxes, self.params, self.factory, self.pool
