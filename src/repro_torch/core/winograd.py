"""Winograd F(4x4, 3x3) minimal filtering, paper §III.D, Eq. (1).

Y = Aᵀ[(G W Gᵀ) ⊙ (Bᵀ X B)] A with 6x6 input tiles and 4x4 output tiles:
36 multiplies per tile instead of 144 for the direct convolution.

This module holds the Lavin-Gray transform matrices, the tile extraction
and the plain torch-op convolution built on them (the interpreter's
optimized mode when no kernel is requested).  ``kernels/winograd_conv``
runs the input transform, the 36 per-position contractions and the output
transform as one CUDA kernel on the input plane and U.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

TILE_IN = 6    # input tile
TILE_OUT = 4   # output tile  (m = 4, r = 3)

# Lavin & Gray, "Fast algorithms for convolutional neural networks".
AT = np.array(
    [
        [1, 1, 1, 1, 1, 0],
        [0, 1, -1, 2, -2, 0],
        [0, 1, 1, 4, 4, 0],
        [0, 1, -1, 8, -8, 1],
    ],
    dtype=np.float32,
)
G = np.array(
    [
        [1 / 4, 0, 0],
        [-1 / 6, -1 / 6, -1 / 6],
        [-1 / 6, 1 / 6, -1 / 6],
        [1 / 24, 1 / 12, 1 / 6],
        [1 / 24, -1 / 12, 1 / 6],
        [0, 0, 1],
    ],
    dtype=np.float32,
)
BT = np.array(
    [
        [4, 0, -5, 0, 1, 0],
        [0, -4, -4, 1, 1, 0],
        [0, 4, -4, -1, 1, 0],
        [0, -2, -1, 2, 1, 0],
        [0, 2, -1, -2, 1, 0],
        [0, 4, 0, -5, 0, 1],
    ],
    dtype=np.float32,
)


def _mat(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(m, dtype=like.dtype, device=like.device)


def transform_weights(w: torch.Tensor) -> torch.Tensor:
    """G W Gᵀ: (3, 3, Cin, Cout) -> (6, 6, Cin, Cout)."""
    g = _mat(G, w)
    return torch.einsum("ij,jkcf,lk->ilcf", g, w, g)


def transform_input(tiles: torch.Tensor) -> torch.Tensor:
    """Bᵀ X B for a batch of 6x6 tiles: (..., 6, 6) -> (..., 6, 6)."""
    bt = _mat(BT, tiles)
    return torch.einsum("ij,...jk,lk->...il", bt, tiles, bt)


def transform_output(tiles: torch.Tensor) -> torch.Tensor:
    """Aᵀ Y A: (..., 6, 6) -> (..., 4, 4)."""
    at = _mat(AT, tiles)
    return torch.einsum("ij,...jk,lk->...il", at, tiles, at)


def tile_geometry(h: int, w: int, padding: str
                  ) -> Tuple[int, int, int, int, int]:
    """(pad, out_h, out_w, th, tw) for a stride-1 3x3 conv."""
    if padding == "SAME":
        pad, out_h, out_w = 1, h, w
    elif padding == "VALID":
        pad, out_h, out_w = 0, h - 2, w - 2
    else:
        raise ValueError(padding)
    return pad, out_h, out_w, -(-out_h // TILE_OUT), -(-out_w // TILE_OUT)


def input_tiles(x: torch.Tensor, padding: str = "SAME"):
    """NHWC ``x`` -> transformed tiles V ``(P, 36, Cin)`` f32, with
    ``P = N * th * tw`` in (n, tile row, tile col) order, plus the
    geometry ``(out_h, out_w, th, tw)``."""
    n, h, w, cin = x.shape
    pad, out_h, out_w, th, tw = tile_geometry(h, w, padding)
    need_h, need_w = th * TILE_OUT + 2, tw * TILE_OUT + 2
    xp = torch.nn.functional.pad(
        x.to(torch.float32),
        (0, 0, pad, need_w - w - pad, pad, need_h - h - pad),
    )
    dev = x.device
    idx_h = (torch.arange(th, device=dev) * TILE_OUT)[:, None] + \
        torch.arange(TILE_IN, device=dev)
    idx_w = (torch.arange(tw, device=dev) * TILE_OUT)[:, None] + \
        torch.arange(TILE_IN, device=dev)
    tiles = xp[:, idx_h][:, :, :, idx_w]           # (N, th, 6, tw, 6, C)
    tiles = tiles.permute(0, 1, 3, 5, 2, 4)        # (N, th, tw, C, 6, 6)
    v = transform_input(tiles)
    v = v.reshape(n * th * tw, cin, 36).transpose(1, 2).contiguous()
    return v, (out_h, out_w, th, tw)


def tile_products(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The 36 per-position contractions of V (P, 36, Cin) with U
    (36, Cin, Cout), then AᵀMA per tile: -> (4, 4, P, Cout)."""
    cout = u.shape[-1]
    m = torch.bmm(v.transpose(0, 1), u)             # (36, P, Cout)
    y = transform_output(m.reshape(6, 6, -1, cout).permute(2, 3, 0, 1))
    return y.permute(2, 3, 0, 1)


def tiles_to_nhwc(y: torch.Tensor, n: int, th: int, tw: int, out_h: int,
                  out_w: int) -> torch.Tensor:
    """(4, 4, P, Cout) output tiles -> cropped NHWC plane."""
    cout = y.shape[-1]
    y = y.reshape(TILE_OUT, TILE_OUT, n, th, tw, cout)
    y = y.permute(2, 3, 0, 4, 1, 5).reshape(n, th * TILE_OUT,
                                            tw * TILE_OUT, cout)
    return y[:, :out_h, :out_w, :]


def winograd_conv2d(x: torch.Tensor, w: torch.Tensor,
                    padding: str = "SAME") -> torch.Tensor:
    """Stride-1 3x3 convolution via F(4x4, 3x3) in plain torch ops.
    x: (N, H, W, Cin) NHWC; w: (3, 3, Cin, Cout) HWIO.  On the card the
    images go one at a time: cuBLAS picks the product's kernel from its
    row count, so a batch could give an image other bits than alone."""
    if x.device.type == "cuda" and x.shape[0] > 1:
        return torch.cat([winograd_conv2d(x[i:i + 1], w, padding)
                          for i in range(x.shape[0])])
    n, _, _, cin = x.shape
    if tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"3x3 kernel over {cin} channels expected, got "
                         f"{tuple(w.shape)}")
    cout = w.shape[3]
    v, (out_h, out_w, th, tw) = input_tiles(x, padding)
    u = transform_weights(w.to(torch.float32)).reshape(36, cin, cout)
    return tiles_to_nhwc(tile_products(v, u), n, th, tw, out_h, out_w)


def multiply_count(h: int, w: int, cin: int, cout: int) -> dict:
    """Multiplies of a 3x3 conv over an (h, w) plane, direct against
    F(4x4, 3x3) (the paper's 144 -> 36 per 4x4 tile), and the transforms'
    operations (the paper rearranges BᵀXB from 12 to 6 multiplies per
    row pass; A and B hold small integers and zeros)."""
    tiles = -(-h // TILE_OUT) * (-(-w // TILE_OUT))
    direct = h * w * 9 * cin * cout
    wino = tiles * 36 * cin * cout
    transforms = tiles * (6 * 6 + 6 * 4) * (cin + cout)
    return {"direct": direct, "winograd_mac": wino,
            "transform_ops": transforms, "mac_reduction": direct / wino}
