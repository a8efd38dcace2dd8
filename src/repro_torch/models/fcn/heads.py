"""Detection heads through the microcode seam (paper §II / Fig. 4).

A :class:`DetectionHead` holds everything model-specific about a
scene-text detector: its LayerSpecs appended after the backbone and the
U-merge, how raw engine outputs become named maps, the serving tail on
the device and the host decode.  :class:`DetectionModel` composes
backbone + U-merge + head into ONE assembled program run by FCNEngine.

This slice of the port carries the paper's own head, PixelLink.  The EAST
and DB heads of the reference are not ported yet; asking for them raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import Assembler, FCNEngine, resolve_device
from repro_torch.core.assembler import Program

from . import backbones as bb
from . import fusion

DEFAULT_MODEL = "pixellink"
NOT_PORTED_MODELS = ("east", "db")


class DetectionHead:
    """One detection model's head: specs, maps, tail, decode.

    ``payload_ranks`` are the ranks of the device tensors :meth:`tail`
    returns before the trailing ``converged`` flag, ``n_payload`` their
    number, and ``supports_device_postprocess`` says whether the
    label-map -> compact-boxes device tail applies (single label-map
    payloads only)."""

    name: str = "base"
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

    @staticmethod
    def _crop_q(arr: np.ndarray, valid_hw: Tuple[int, int]) -> np.ndarray:
        vh, vw = valid_hw[0] // 4, valid_hw[1] // 4
        return np.asarray(arr)[:vh, :vw]


class PixelLinkHead(DetectionHead):
    """1 score + 8 neighbour-link channels, CC over positive links."""

    name = "pixellink"
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


MODEL_ZOO: Dict[str, type] = {"pixellink": PixelLinkHead}


def check_model(model: str) -> str:
    if model in NOT_PORTED_MODELS:
        raise NotImplementedError(
            f"the {model!r} head is not ported to repro_torch yet")
    if model not in MODEL_ZOO:
        raise ValueError(f"unknown model {model!r}; expected one of "
                         f"{tuple(sorted(MODEL_ZOO))}")
    return model


def build_head(model: str, *, score_thr: float = 0.5,
               link_thr: float = 0.5) -> DetectionHead:
    return MODEL_ZOO[check_model(model)](score_thr=score_thr,
                                         link_thr=link_thr)


class DetectionModel:
    """Backbone + U-merge + one head, assembled to ONE microcode program.

    ``cfg`` carries the STDConfig fields (backbone, width, image_size,
    merge_ch, upsample_mode, mode, bfp, storage_fp16, use_kernels,
    memplan).  Parameters and activations live on ``device``."""

    def __init__(self, cfg, head: DetectionHead, device="cuda"):
        self.cfg = cfg
        self.head = head
        self.device = resolve_device(device)
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
        )

    def init_params(self, generator: torch.Generator):
        return self.engine.init_params(generator, self.device)

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
