"""Detection heads through the microcode seam (paper §II / Fig. 4).

A :class:`DetectionHead` holds everything model-specific about a
scene-text detector: its LayerSpecs appended after the backbone and the
U-merge, how raw engine outputs become named maps, the serving tail on
the device and the host decode.  :class:`DetectionModel` composes
backbone + U-merge + head into ONE assembled program run by FCNEngine.

Three heads ship, as in the JAX package: :class:`PixelLinkHead` (the
paper's own: 1 score + 8 link channels, CC over positive links),
:class:`EASTHead` (1 score + 4 edge distances per pixel, greedy NMS on
the host, no CC tail) and :class:`DBHead` (a residual 3x3/1x1 merge
through the ``add`` microcode op, one shrink-mask channel, plain
8-connected CC and the DB unclip at decode).  ``MODEL_ZOO`` and
:func:`build_head` are the registry the engine factory and the serving
layer route by; each head's ``reference_decode`` is an independent NumPy
oracle for its serving decode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import Assembler, FCNEngine, resolve_device
from repro_torch.core.assembler import LayerSpec, Program

from . import backbones as bb
from . import fusion

DEFAULT_MODEL = "pixellink"


def _valid_mask(score: torch.Tensor, valid_q: torch.Tensor) -> torch.Tensor:
    """(N, h, w) bool mask of each image's valid region (quarter-resolution
    heights and widths in ``valid_q`` (N, 2)), shared by the CC tail and
    the regression heads."""
    h, w = score.shape[1:]
    dev = score.device
    return ((torch.arange(h, device=dev)[None, :, None]
             < valid_q[:, 0, None, None])
            & (torch.arange(w, device=dev)[None, None, :]
               < valid_q[:, 1, None, None]))


def _iou(a: Tuple[int, int, int, int], b: Tuple[int, int, int, int]) -> float:
    """Inclusive-pixel IoU of two (x0, y0, x1, y1) boxes."""
    ix = min(a[2], b[2]) - max(a[0], b[0]) + 1
    iy = min(a[3], b[3]) - max(a[1], b[1]) + 1
    if ix <= 0 or iy <= 0:
        return 0.0
    inter = ix * iy
    aa = (a[2] - a[0] + 1) * (a[3] - a[1] + 1)
    bb_ = (b[2] - b[0] + 1) * (b[3] - b[1] + 1)
    return inter / float(aa + bb_ - inter)


def db_unclip_box(box: Dict, valid_hw_q: Tuple[int, int],
                  ratio: float) -> Dict:
    """DB's unclip on one tight component box: grow it by ``delta = area *
    ratio / perimeter`` (the polygon offset of an axis-aligned rectangle),
    clipped to the valid quarter-resolution plane."""
    x0, y0, x1, y1 = box["box"]
    w, h = x1 - x0 + 1, y1 - y0 + 1
    d = int(round(w * h * ratio / (2.0 * (w + h))))
    vh, vw = valid_hw_q
    out = dict(box)
    out["box"] = (max(0, x0 - d), max(0, y0 - d),
                  min(vw - 1, x1 + d), min(vh - 1, y1 + d))
    return out


class DetectionHead:
    """One detection model's head: specs, maps, tail, decode.

    ``maps`` are the ``(name, rank)`` pairs :meth:`model_outputs` returns
    besides the logits (rank counts the batch axis), ``payload_ranks``
    the ranks of the device tensors :meth:`tail` returns before the
    trailing ``converged`` flag, ``n_payload`` their number, and
    ``supports_device_postprocess`` says whether the label-map ->
    compact-boxes device tail applies (single label-map payloads only)."""

    name: str = "base"
    maps: Tuple[Tuple[str, int], ...] = ()
    payload_ranks: Tuple[int, ...] = (3,)
    n_payload: int = 1
    supports_device_postprocess: bool = False

    def __init__(self, score_thr: float = 0.5, link_thr: float = 0.5):
        self.score_thr = float(score_thr)
        self.link_thr = float(link_thr)

    def head_specs(self, feat: str):
        raise NotImplementedError

    def model_outputs(self, raw: Dict[str, torch.Tensor]):
        raise NotImplementedError

    def tail(self, factory, out, valid_q):
        raise NotImplementedError

    def payload_plane(self, payload: Any) -> Optional[Tuple[int, int]]:
        """Quarter-resolution (h, w) plane of one image's payload, or None
        for device-compact rows, which carry no plane."""
        if isinstance(payload, tuple):
            return None
        return tuple(np.asarray(payload).shape[:2])

    def decode(self, payload: Any, valid_hw: Tuple[int, int]
               ) -> Tuple[List[Dict], str]:
        """One image's payload -> ``(boxes, kind)``, kind naming the
        postprocess telemetry series ("host" or "device")."""
        raise NotImplementedError

    def reference_decode(self, out: Dict[str, np.ndarray],
                         valid_hw: Tuple[int, int]) -> List[Dict]:
        """Independent NumPy oracle: one image's maps (no batch axis) ->
        boxes, for comparison with the serving tail and :meth:`decode`."""
        raise NotImplementedError

    @staticmethod
    def _crop_q(arr: np.ndarray, valid_hw: Tuple[int, int]) -> np.ndarray:
        vh, vw = valid_hw[0] // 4, valid_hw[1] // 4
        return np.asarray(arr)[:vh, :vw]


class PixelLinkHead(DetectionHead):
    """1 score + 8 neighbour-link channels, CC over positive links."""

    name = "pixellink"
    maps = (("score", 3), ("links", 4))
    payload_ranks = (3,)
    n_payload = 1
    supports_device_postprocess = True

    def head_specs(self, feat):
        return fusion.pixellink_head(feat)

    def model_outputs(self, raw):
        prob = raw["head_prob"].to(torch.float32)
        return {
            "logits": raw["head_logits"].to(torch.float32),
            "score": prob[..., 0],
            "links": prob[..., 1:],
        }

    def tail(self, factory, out, valid_q):
        return factory.label_tail(out["score"], out["links"], valid_q)

    def decode(self, payload, valid_hw):
        """A ``(rows, count)`` tuple is the device-compact payload, a
        label map the host one."""
        from . import postprocess as pp

        if isinstance(payload, tuple):
            return pp.boxes_from_compact(payload[0]), "device"
        return pp.boxes_from_labels(self._crop_q(payload, valid_hw)), "host"

    def reference_decode(self, out, valid_hw):
        from . import postprocess as pp

        score = self._crop_q(out["score"], valid_hw)
        links = self._crop_q(out["links"], valid_hw)
        labels = pp.cc_label_numpy(score, links, self.score_thr,
                                   self.link_thr)
        return pp.boxes_from_labels_reference(labels)


def _kept(box, score, kept: List[Dict]) -> None:
    kept.append({"label": len(kept) + 1, "box": box,
                 "area": (box[2] - box[0] + 1) * (box[3] - box[1] + 1),
                 "score": score})


class EASTHead(DetectionHead):
    """EAST-style direct regression: per-pixel score + 4 edge distances
    (top, right, bottom, left, in quarter-resolution pixels), decoded on
    the host with greedy NMS.  No CC tail: the payload is the masked score
    map and the geometry map."""

    name = "east"
    maps = (("score", 3), ("geo", 4))
    payload_ranks = (3, 4)
    n_payload = 2
    supports_device_postprocess = False

    #: sigmoid output x scale = edge distance in quarter-resolution pixels
    GEO_SCALE = 8.0
    #: greedy-NMS suppression threshold
    NMS_IOU = 0.5

    def __init__(self, score_thr: float = 0.5, link_thr: float = 0.5, *,
                 geo_scale: float = GEO_SCALE, nms_iou: float = NMS_IOU):
        super().__init__(score_thr, link_thr)
        self.geo_scale = float(geo_scale)
        self.nms_iou = float(nms_iou)

    def head_specs(self, feat):
        specs = [
            LayerSpec("head_logits", "conv", [feat], out_ch=5, kernel=1),
            LayerSpec("head_prob", "sigmoid", ["head_logits"]),
        ]
        return specs, ["head_logits", "head_prob"]

    def model_outputs(self, raw):
        prob = raw["head_prob"].to(torch.float32)
        return {
            "logits": raw["head_logits"].to(torch.float32),
            "score": prob[..., 0],
            "geo": prob[..., 1:] * self.geo_scale,
        }

    def tail(self, factory, out, valid_q):
        score = out["score"]
        masked = score.masked_fill(~_valid_mask(score, valid_q), 0.0)
        converged = torch.ones((score.shape[0],), dtype=torch.bool,
                               device=score.device)
        return masked, out["geo"].to(torch.float32), converged

    def payload_plane(self, payload):
        return tuple(np.asarray(payload[0]).shape[:2])

    def _candidates(self, score: np.ndarray, geo: np.ndarray):
        """Thresholded pixels -> clipped integer candidate boxes in
        (-score, y, x) order, vectorised (the reference decode redoes
        this pixel by pixel)."""
        vh, vw = score.shape
        ys, xs = np.nonzero(score > self.score_thr)
        if ys.size == 0:
            return [], []
        d = geo[ys, xs]                      # (n, 4) order (t, r, b, l)
        x0 = np.clip(np.rint(xs - d[:, 3]), 0, vw - 1).astype(np.int64)
        y0 = np.clip(np.rint(ys - d[:, 0]), 0, vh - 1).astype(np.int64)
        x1 = np.clip(np.rint(xs + d[:, 1]), 0, vw - 1).astype(np.int64)
        y1 = np.clip(np.rint(ys + d[:, 2]), 0, vh - 1).astype(np.int64)
        sc = score[ys, xs]
        order = np.lexsort((xs, ys, -sc))    # -score first, then y, x
        boxes = [(int(x0[i]), int(y0[i]), int(x1[i]), int(y1[i]))
                 for i in order]
        return boxes, [float(sc[i]) for i in order]

    @staticmethod
    def _nms(boxes, scores, iou_thr: float) -> List[Dict]:
        kept: List[Dict] = []
        for box, sc in zip(boxes, scores):
            if all(_iou(box, k["box"]) <= iou_thr for k in kept):
                _kept(box, sc, kept)
        return kept

    def decode(self, payload, valid_hw):
        score, geo = payload
        vh, vw = valid_hw[0] // 4, valid_hw[1] // 4
        score = np.asarray(score)[:vh, :vw]
        geo = np.asarray(geo)[:vh, :vw]
        boxes, scores = self._candidates(score, geo)
        return self._nms(boxes, scores, self.nms_iou), "host"

    def reference_decode(self, out, valid_hw):
        score = self._crop_q(out["score"], valid_hw)
        geo = self._crop_q(out["geo"], valid_hw)
        vh, vw = score.shape
        cands = []
        for y in range(vh):                   # pure-Python oracle
            for x in range(vw):
                if not score[y, x] > self.score_thr:
                    continue
                t, r, b, l = (geo[y, x, 0], geo[y, x, 1],
                              geo[y, x, 2], geo[y, x, 3])
                box = (int(min(max(np.rint(x - l), 0), vw - 1)),
                       int(min(max(np.rint(y - t), 0), vh - 1)),
                       int(min(max(np.rint(x + r), 0), vw - 1)),
                       int(min(max(np.rint(y + b), 0), vh - 1)))
                cands.append((-float(score[y, x]), y, x, box))
        cands.sort(key=lambda c: c[:3])
        kept: List[Dict] = []
        for neg_sc, _, _, box in cands:
            if all(_iou(box, k["box"]) <= self.nms_iou for k in kept):
                _kept(box, -neg_sc, kept)
        return kept


class DBHead(DetectionHead):
    """DB/FAST-style minimalist head: a residual 3x3/1x1 merge through the
    binary ``add`` microcode op (the residual read via ``ext_addr2``), ONE
    sigmoid shrink-mask channel, plain 8-connected CC over the mask, and
    DB's unclip at decode.  Its payload is one label map, so the device
    box tail applies."""

    name = "db"
    maps = (("score", 3),)
    payload_ranks = (3,)
    n_payload = 1
    supports_device_postprocess = True

    #: unclip growth factor (DB's r)
    UNCLIP_RATIO = 1.5
    #: residual-merge width
    HEAD_CH = 16

    def __init__(self, score_thr: float = 0.5, link_thr: float = 0.5, *,
                 unclip_ratio: float = UNCLIP_RATIO, head_ch: int = HEAD_CH):
        super().__init__(score_thr, link_thr)
        self.unclip_ratio = float(unclip_ratio)
        self.head_ch = int(head_ch)

    def head_specs(self, feat):
        ch = self.head_ch
        specs = [
            LayerSpec("db_c3", "conv", [feat], out_ch=ch, kernel=3,
                      relu=True, bn=True, bias=False),
            LayerSpec("db_r1", "conv", ["db_c3"], out_ch=ch, kernel=1,
                      bn=True, bias=False),
            # reads db_r1 at in_addr and db_c3 via ext_addr2: the channels
            # match (never summed as in a concat)
            LayerSpec("db_add", "add", ["db_r1", "db_c3"], relu=True),
            LayerSpec("head_logits", "conv", ["db_add"], out_ch=1,
                      kernel=1),
            LayerSpec("head_prob", "sigmoid", ["head_logits"]),
        ]
        return specs, ["head_logits", "head_prob"]

    def model_outputs(self, raw):
        prob = raw["head_prob"].to(torch.float32)
        return {
            "logits": raw["head_logits"].to(torch.float32),
            "score": prob[..., 0],
        }

    def tail(self, factory, out, valid_q):
        score = out["score"]
        # all-positive links make the CC tail plain 8-connected labelling
        # of the thresholded mask (link_thr < 1 always passes)
        links = torch.ones(score.shape + (8,), dtype=score.dtype,
                           device=score.device)
        return factory.label_tail(score, links, valid_q)

    def _unclip(self, boxes: List[Dict],
                valid_hw: Tuple[int, int]) -> List[Dict]:
        vq = (valid_hw[0] // 4, valid_hw[1] // 4)
        return [db_unclip_box(b, vq, self.unclip_ratio) for b in boxes]

    def decode(self, payload, valid_hw):
        from . import postprocess as pp

        if isinstance(payload, tuple):          # device-compact rows
            return self._unclip(pp.boxes_from_compact(payload[0]),
                                valid_hw), "device"
        boxes = pp.boxes_from_labels(self._crop_q(payload, valid_hw))
        return self._unclip(boxes, valid_hw), "host"

    def reference_decode(self, out, valid_hw):
        from . import postprocess as pp

        score = self._crop_q(out["score"], valid_hw)
        links = np.ones(score.shape + (8,), np.float32)
        labels = pp.cc_label_numpy(score, links, self.score_thr,
                                   self.link_thr)
        return self._unclip(pp.boxes_from_labels_reference(labels),
                            valid_hw)


MODEL_ZOO: Dict[str, type] = {
    "pixellink": PixelLinkHead,
    "east": EASTHead,
    "db": DBHead,
}


def check_model(model: str) -> str:
    if model not in MODEL_ZOO:
        raise ValueError(f"unknown model {model!r}; expected one of "
                         f"{tuple(sorted(MODEL_ZOO))}")
    return model


def build_head(model: str, *, score_thr: float = 0.5,
               link_thr: float = 0.5, **kw) -> DetectionHead:
    """One configured head from the zoo; ``kw`` are the head's own options
    (``geo_scale``, ``nms_iou``, ``unclip_ratio``, ``head_ch``)."""
    return MODEL_ZOO[check_model(model)](score_thr=score_thr,
                                         link_thr=link_thr, **kw)


class DetectionModel:
    """Backbone + U-merge + one head, assembled to ONE microcode program.

    ``cfg`` carries the STDConfig fields (backbone, width, image_size,
    merge_ch, upsample_mode, mode, bfp, storage_fp16, use_kernels,
    memplan).  Parameters and activations live on ``device``.  A model
    with ``plane_bands`` > 1 runs one of that many row bands of a larger
    plane (:meth:`for_plane`, :meth:`band_walk`)."""

    def __init__(self, cfg, head: DetectionHead, device="cuda",
                 plane_bands: int = 1):
        self.cfg = cfg
        self.head = head
        self.device = resolve_device(device)
        self.plane_bands = int(plane_bands)
        h, w = cfg.image_size
        specs, taps = bb.BACKBONES[cfg.backbone](cfg.width)
        fspecs, fout = fusion.east_merge(taps, cfg.merge_ch,
                                         cfg.upsample_mode)
        hspecs, outs = head.head_specs(fout)
        self.program: Program = Assembler((h, w, 3)).assemble(
            specs + fspecs + hspecs, outputs=outs)
        self.engine = FCNEngine(
            self.program, mode=cfg.mode, bfp=cfg.bfp,
            storage_dtype=torch.float16 if cfg.storage_fp16 else torch.float32,
            use_kernels=cfg.use_kernels, memplan=cfg.memplan,
            plane_bands=plane_bands,
        )

    def init_params(self, generator: torch.Generator):
        return self.engine.init_params(generator, self.device)

    def for_plane(self, image_size: Tuple[int, int], device=None,
                  plane_bands: int = 1) -> "DetectionModel":
        """The same architecture assembled for another input plane, on
        ``device`` (default: this model's); fully convolutional, so the
        parameters carry over 1:1.  The row-band plans build their
        band-plane program this way, with ``plane_bands`` bands."""
        return DetectionModel(
            dataclasses.replace(self.cfg, image_size=tuple(image_size)),
            self.head, self.device if device is None else device,
            plane_bands)

    def normalize_weights(self, params):
        return self.engine.normalize_weights(params)

    def apply(self, params, images, *, transposed: bool = False
              ) -> Dict[str, torch.Tensor]:
        """images (N, H, W, 3) -> the head's named maps + logits."""
        if images.ndim != 4:
            raise ValueError(
                f"images must be (N, H, W, 3), got shape {tuple(images.shape)}")
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        raw = self.engine(params, images, transposed=transposed)
        return self.head.model_outputs(raw)

    def band_walk(self, params, images: torch.Tensor, trace=None):
        """One row band's forward pass as a generator (``FCNEngine.walk``
        with ``banded=True``): it yields ``(x, halo)`` at each halo
        exchange and its value is the band's named maps + logits."""
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        raw = yield from self.engine.walk(params, images, banded=True,
                                          trace=trace)
        return self.head.model_outputs(raw)

    def microcode_bytes(self) -> np.ndarray:
        """The program's packed microcode (32 bytes a word)."""
        from repro_torch.core.microcode import pack_program

        return pack_program(self.program.words)


PARAM_LEAVES = ("w", "b", "gamma", "beta", "mean", "var")


def params_from_numpy(tree, device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
    """A reference parameter tree ``{binding: {leaf: array}}`` -> the
    port's, as f32 tensors on ``device``.  ``w`` stays HWIO."""
    out = {}
    for name, leaves in tree.items():
        extra = set(leaves) - set(PARAM_LEAVES)
        if extra:
            raise ValueError(f"{name}: unexpected parameter leaves {extra}")
        out[name] = {
            k: torch.tensor(np.asarray(v, dtype=np.float32), device=device)
            for k, v in leaves.items()
        }
    return out
