"""K1 wrapper: Winograd F(4x4, 3x3) conv with bias + ReLU fused.

:func:`winograd_tiles` takes the NHWC input plane and the transformed
weights U = G W Gᵀ ``(36, Cin, Cout)`` and returns the cropped NHWC
output.  On a CUDA tensor it launches the kernel in
``csrc/winograd_conv.cu``, which forms the transformed input tiles BᵀXB
in shared memory, contracts them with U, and applies AᵀMA, bias and
ReLU; on a CPU tensor it runs :func:`winograd_tiles_plain`, the same
function in torch ops.  U stays a torch op in :func:`winograd_conv2d`,
as the reference leaves it to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import winograd as wg
from repro_torch.kernels import build, refuse_autograd

PADS = {"SAME": 1, "VALID": 0}


def winograd_tiles_plain(x, u, b, *, padding: str, relu: bool
                         ) -> torch.Tensor:
    """Plain torch version of the kernel, on the same operands."""
    n = x.shape[0]
    v, (out_h, out_w, th, tw) = wg.input_tiles(x, padding)
    y = wg.tile_products(v, u)                         # (4, 4, P, Cout)
    if b is not None:
        y = y + b
    if relu:
        y = torch.relu(y)
    return wg.tiles_to_nhwc(y, n, th, tw, out_h, out_w)


def winograd_tiles(x: torch.Tensor, u: torch.Tensor,
                   b: Optional[torch.Tensor] = None, *,
                   padding: str = "SAME", relu: bool = False) -> torch.Tensor:
    """(n, H, W, Cin) x (36, Cin, Cout) -> (n, out_h, out_w, Cout) f32."""
    refuse_autograd("winograd_tiles", x, u, b)
    n, h, w, cin = x.shape
    cout = u.shape[-1]
    if padding not in PADS:
        raise ValueError(f"winograd_tiles: padding {padding!r}")
    pad = PADS[padding]
    out_h, out_w = h + 2 * pad - 2, w + 2 * pad - 2
    if (u.dim() != 3 or tuple(u.shape[:2]) != (36, cin) or out_h < 1
            or out_w < 1 or (b is not None and tuple(b.shape) != (cout,))):
        raise ValueError(f"winograd_tiles: x {tuple(x.shape)}, U "
                         f"{tuple(u.shape)}, padding {padding}")
    if x.device.type == "cpu":
        return winograd_tiles_plain(x, u, b, padding=padding, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"winograd_tiles: unsupported device {x.device}")
    tensors = [x, u] + ([b] if b is not None else [])
    for t in tensors:
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("winograd_tiles takes contiguous f32 tensors "
                             "on one device")
    out = torch.empty((n, out_h, out_w, cout), device=x.device,
                      dtype=torch.float32)
    lib = build.library()
    build.check(lib.winograd_conv_fused(
        x.data_ptr(), u.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), n, h, w, cin, cout, pad, out_h, out_w, int(relu),
        build.stream_handle(x.device)), "winograd_conv_fused")
    winograd_tiles.launches += 1
    return out


winograd_tiles.launches = 0


def winograd_conv2d(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None, *,
                    padding: str = "SAME", relu: bool = False
                    ) -> torch.Tensor:
    """Stride-1 3x3 conv (NHWC x HWIO) with bias + ReLU fused."""
    cin = x.shape[3]
    if tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"3x3 kernel over {cin} channels expected, got "
                         f"{tuple(w.shape)}")
    u = wg.transform_weights(w.to(torch.float32)).reshape(36, cin, -1)
    bias = None if b is None else b.to(torch.float32).contiguous()
    return winograd_tiles(x.to(torch.float32).contiguous(), u.contiguous(),
                          bias, padding=padding, relu=relu)
