"""K3 wrapper: connected-component labelling in two phases.

Phase 1, :func:`local_spread_converge`, runs every (th, tw) tile of every
image to its tile-local spread fixpoint; on a CUDA tensor that launches
``csrc/cc_label.cu`` (row and column scans between full 8-neighbour
hops), on a CPU tensor it runs :func:`local_spread_converge_plain` (the
reference's Jacobi loop).  Phase 2 stitches the tiles with
global one-hop spread + pointer-jump rounds in torch ops, up to
``max_iters`` per image.  Both phases are monotone toward the same
fixpoint as the plain spread, so :func:`cc_label_tiled` returns exactly
the labels of ``postprocess.cc_label_batched(hop="log")``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, refuse_autograd
from repro_torch.models.fcn import postprocess as pp
from repro_torch.runtime.telemetry import SPANS

MAX_TILE = 32


def _tiles(a: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """(N, H, W, ...) -> (N * H/th * W/tw, th, tw, ...)."""
    n, h, w = a.shape[:3]
    rest = a.shape[3:]
    a = a.reshape(n, h // th, th, w // tw, tw, *rest)
    a = a.transpose(2, 3)
    return a.reshape(-1, th, tw, *rest)


def local_spread_jacobi(labels, pos, lnk, *, th: int, tw: int):
    """The reference's loop in torch: Jacobi rounds of the one-hop spread
    on every tile until it stops changing.  Returns ``(labels, rounds)``
    with the per-tile round count (N, H/th, W/tw)."""
    n, h, w = labels.shape
    lab = _tiles(labels, th, tw)
    p = _tiles(pos, th, tw) != 0
    lk = _tiles(lnk, th, tw) != 0
    out, rounds, _ = pp.merge_rounds(lab, p, lk, th * tw, hop="one")
    out = out.reshape(n, h // th, w // tw, th, tw).transpose(2, 3)
    return out.reshape(n, h, w), rounds.reshape(n, h // th, w // tw)


def local_spread_converge_plain(labels, pos, lnk, *, th: int, tw: int):
    """Plain torch version of the kernel: the tile-local fixpoint labels."""
    return local_spread_jacobi(labels, pos, lnk, th=th, tw=tw)[0]


def local_spread_converge(labels: torch.Tensor, pos: torch.Tensor,
                          lnk: torch.Tensor, *, th: int = MAX_TILE,
                          tw: int = MAX_TILE) -> torch.Tensor:
    """labels, pos (N, H, W) int32 and lnk (N, H, W, 8) int32 -> the
    tile-local fixpoint labels (N, H, W) int32.  H and W must be tile
    multiples.  The CUDA kernel reaches the fixpoint by row and column
    scans between full hops, in fewer rounds than the reference's Jacobi
    loop (:func:`local_spread_jacobi` counts those)."""
    n, h, w = labels.shape
    if h % th or w % tw or not (0 < th <= MAX_TILE and 0 < tw <= MAX_TILE):
        raise ValueError(f"plane {(h, w)} is not a multiple of tiles "
                         f"{(th, tw)} (at most {MAX_TILE})")
    if tuple(pos.shape) != (n, h, w) or tuple(lnk.shape) != (n, h, w, 8):
        raise ValueError(f"local_spread_converge: shapes "
                         f"{tuple(labels.shape)} {tuple(pos.shape)} "
                         f"{tuple(lnk.shape)}")
    if labels.device.type == "cpu":
        return local_spread_converge_plain(labels, pos, lnk, th=th, tw=tw)
    if labels.device.type != "cuda":
        raise ValueError(f"cc_label: unsupported device {labels.device}")
    for t in (labels, pos, lnk):
        if t.device != labels.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError("local_spread_converge takes contiguous int32 "
                             "tensors on one device")
    if lnk.data_ptr() % 16:                  # two 16-byte loads a pixel
        raise ValueError("local_spread_converge takes 16-byte aligned links")
    out = torch.empty_like(labels)
    lib = build.library()
    build.check(lib.cc_local_spread(
        labels.data_ptr(), pos.data_ptr(), lnk.data_ptr(), out.data_ptr(),
        n, h, w, th, tw, build.stream_handle(labels.device)),
        "cc_local_spread")
    local_spread_converge.launches += 1
    return out


local_spread_converge.launches = 0


def cc_label_tiled(score: torch.Tensor, links: torch.Tensor,
                   score_thr: float = 0.5, link_thr: float = 0.5,
                   max_iters: int = 256,
                   valid_mask: Optional[torch.Tensor] = None, *,
                   th: int = MAX_TILE, tw: int = MAX_TILE,
                   return_stats: bool = False):
    """(N, H, W) scores + (N, H, W, 8) links -> (N, H, W) int32 labels,
    equal to ``cc_label_batched(hop="log")``.  ``max_iters`` bounds the
    phase-2 rounds; with ``return_stats`` the result is ``(labels, iters,
    converged)`` per image.  Planes that are not tile multiples are
    zero-padded for phase 1 only (padding is background)."""
    refuse_autograd("cc_label_tiled", score, links)
    pos, lnk = pp._prepare(score, links, score_thr, link_thr, valid_mask)
    n, h, w = pos.shape
    bh, bw = min(th, h), min(tw, w)
    ph, pw = (-h) % bh, (-w) % bw

    def pad(a):
        a = a.to(torch.int32)
        if not (ph or pw):
            return a.contiguous()
        cfg = (0, 0) * (a.ndim - 3) + (0, pw, 0, ph)
        return F.pad(a, cfg).contiguous()

    with SPANS.span("cc.local"):
        local = local_spread_converge(pad(pp.cc_init_labels(pos)), pad(pos),
                                      pad(lnk), th=bh, tw=bw)
    labels, iters, converged = pp.merge_rounds(
        local[:, :h, :w], pos, lnk, max_iters)
    if return_stats:
        return labels, iters, converged
    return labels
