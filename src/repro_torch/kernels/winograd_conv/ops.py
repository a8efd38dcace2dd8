"""K1 wrapper: Winograd F(4x4, 3x3) conv with bias + ReLU fused.

Tile extraction and the input transform BᵀXB stay in torch ops (as the
reference leaves them to XLA); :func:`winograd_tiles` then contracts the
transformed tiles V ``(P, 36, Cin)`` with the transformed weights U
``(36, Cin, Cout)``, applies AᵀMA, bias and ReLU, and writes the cropped
NHWC plane.  On a CUDA tensor it launches the kernel in
``csrc/winograd_conv.cu``; on a CPU tensor it runs
:func:`winograd_tiles_plain`, the same function in torch ops.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import winograd as wg
from repro_torch.kernels import build


def winograd_tiles_plain(v, u, b, *, relu: bool, n: int, th: int, tw: int,
                         out_h: int, out_w: int) -> torch.Tensor:
    """Plain torch version of the kernel, on the same operands."""
    y = wg.tile_products(v, u)                         # (4, 4, P, Cout)
    if b is not None:
        y = y + b
    if relu:
        y = torch.relu(y)
    return wg.tiles_to_nhwc(y, n, th, tw, out_h, out_w)


def winograd_tiles(v: torch.Tensor, u: torch.Tensor,
                   b: Optional[torch.Tensor] = None, *, relu: bool = False,
                   n: int, th: int, tw: int, out_h: int, out_w: int
                   ) -> torch.Tensor:
    """(P, 36, Cin) x (36, Cin, Cout) -> (n, out_h, out_w, Cout) f32."""
    P, z, cin = v.shape
    cout = u.shape[-1]
    if (z != 36 or tuple(u.shape[:2]) != (36, cin) or P != n * th * tw
            or not (0 < out_h <= 4 * th and 0 < out_w <= 4 * tw)
            or (b is not None and tuple(b.shape) != (cout,))):
        raise ValueError(f"winograd_tiles: V {tuple(v.shape)}, U "
                         f"{tuple(u.shape)}, n*th*tw={n * th * tw}, output "
                         f"{(out_h, out_w)}")
    if v.device.type == "cpu":
        return winograd_tiles_plain(v, u, b, relu=relu, n=n, th=th, tw=tw,
                                    out_h=out_h, out_w=out_w)
    if v.device.type != "cuda":
        raise ValueError(f"winograd_tiles: unsupported device {v.device}")
    tensors = [v, u] + ([b] if b is not None else [])
    for t in tensors:
        if t.device != v.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("winograd_tiles takes contiguous f32 tensors "
                             "on one device")
    out = torch.empty((n, out_h, out_w, cout), device=v.device,
                      dtype=torch.float32)
    lib = build.library()
    build.check(lib.winograd_tile_conv(
        v.data_ptr(), u.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), n, th, tw, cin, cout, out_h, out_w, int(relu),
        build.stream_handle(v.device)), "winograd_tile_conv")
    winograd_tiles.launches += 1
    return out


winograd_tiles.launches = 0


def winograd_conv2d(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None, *,
                    padding: str = "SAME", relu: bool = False
                    ) -> torch.Tensor:
    """Stride-1 3x3 conv (NHWC x HWIO) with bias + ReLU fused."""
    n, _, _, cin = x.shape
    if tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"3x3 kernel over {cin} channels expected, got "
                         f"{tuple(w.shape)}")
    cout = w.shape[3]
    v, (out_h, out_w, th, tw) = wg.input_tiles(x, padding)
    u = wg.transform_weights(w.to(torch.float32)).reshape(36, cin, cout)
    bias = None if b is None else b.to(torch.float32).contiguous()
    return winograd_tiles(v, u.contiguous(), bias, relu=relu, n=n, th=th,
                          tw=tw, out_h=out_h, out_w=out_w)
