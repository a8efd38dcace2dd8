"""Complexity-reduction fusions (paper contribution C6) and the plain
convolution/pooling helpers, in torch ops over NHWC/HWIO tensors.

1. BatchNorm folding into the preceding convolution:
       conv(x, W * s) + (b - mean) * s + beta,   s = gamma / sqrt(var + eps)
2. Upsample padding minimization: a 2x zero-insertion upsample followed by
   a 3x3 convolution is phase-decomposed over the four output phases, so
   only the non-zero taps are computed (9 taps per 4 outputs instead of
   36, the paper's 75% reduction).
3. Conv epilogue fusion: bias + ReLU ride the conv launch unless the word
   uses the residual register, which reads the pre-activation value.

Padding follows XLA's ``"SAME"`` rule for any window and stride: the total
padding ``max((ceil(n / s) - 1) * s + k - n, 0)`` is split with the
smaller half first, which is asymmetric for even windows and strides
above 1.  ``F.conv2d`` and the pooling ops pad symmetrically, so the
padding is applied explicitly with ``F.pad`` before them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def fold_batchnorm(w, b, gamma, beta, mean, var, eps: float = 1e-5):
    """Fold BN(conv(x, w) + b) into one conv's (w', b'); w is HWIO."""
    s = gamma * torch.rsqrt(var + eps)
    w_f = w * s[None, None, None, :]
    b0 = torch.zeros_like(beta) if b is None else b
    return w_f, (b0 - mean) * s + beta


def can_fuse_conv_epilogue(mc) -> bool:
    """A conv word's ReLU may fuse into the conv launch only when the word
    has no residual op (the register reads the pre-activation value)."""
    from .microcode import ResOp

    return bool(mc.relu) and mc.res_op == ResOp.NONE


def conv_epilogue(y: torch.Tensor, b: Optional[torch.Tensor] = None,
                  relu: bool = False) -> torch.Tensor:
    if b is not None:
        y = y + b
    if relu:
        y = torch.relu(y)
    return y


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA ``"SAME"`` padding (lo, hi) of one spatial dim."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same_nhwc(x: torch.Tensor, kh: int, kw: int, s: int,
                   value: float = 0.0):
    h_lo, h_hi = same_pads(x.shape[1], kh, s)
    w_lo, w_hi = same_pads(x.shape[2], kw, s)
    if h_lo or h_hi or w_lo or w_hi:
        x = F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi), value=value)
    return x


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _oihw(w):
    return w.permute(3, 2, 0, 1)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding="SAME", groups: int = 1) -> torch.Tensor:
    """NHWC x HWIO convolution with XLA padding semantics.  ``padding``
    is ``"SAME"``, ``"VALID"`` or explicit ``((h_lo, h_hi), (w_lo,
    w_hi))``.

    On the card the images go through cuDNN one at a time: cuDNN picks
    its algorithm from the whole input shape, the batch included, and the
    algorithms round differently, so a batched call could give an image
    other bits than serving it alone."""
    if x.device.type == "cuda" and x.shape[0] > 1:
        return torch.cat([conv2d_nhwc(x[i:i + 1], w, stride, padding, groups)
                          for i in range(x.shape[0])])
    kh, kw = w.shape[:2]
    if padding == "SAME":
        x = _pad_same_nhwc(x, kh, kw, stride)
    elif padding != "VALID":
        (h_lo, h_hi), (w_lo, w_hi) = padding
        x = F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi))
    y = F.conv2d(_nchw(x), _oihw(w), stride=stride, groups=groups)
    return _nhwc(y)


def pool_nhwc(x: torch.Tensor, k: int, s: int, kind: str = "max"
              ) -> torch.Tensor:
    """``lax.reduce_window`` max/sum pooling with SAME padding (the pad
    value is -inf for max and 0 for the sum, divided by k*k for avg)."""
    x = x.to(torch.float32)
    if kind == "max":
        xp = _pad_same_nhwc(x, k, k, s, value=float("-inf"))
        return _nhwc(F.max_pool2d(_nchw(xp), k, s))
    xp = _pad_same_nhwc(x, k, k, s, value=0.0)
    return _nhwc(F.avg_pool2d(_nchw(xp), k, s))


# ---------------------------------------------------------------------------
# Upsample-conv phase decomposition
# ---------------------------------------------------------------------------

def zero_insert_2x(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    out = x.new_zeros((n, 2 * h, 2 * w, c))
    out[:, ::2, ::2, :] = x
    return out


def upsample2x_conv3x3_naive(x: torch.Tensor, w: torch.Tensor
                             ) -> torch.Tensor:
    """conv3x3(zero_insert_2x(x)), SAME padding: 36 MACs per 4 outputs."""
    return conv2d_nhwc(zero_insert_2x(x), w, 1, "SAME")


# pixels per tap-product GEMM: every call has this one shape
UPSAMPLE_GEMM_ROWS = 2048


def _tap_products(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, h, w, Cin) x (3, 3, Cin, Cout) -> (n, h, w, 3, 3, Cout): each
    pixel times each tap.  The pixels go through GEMMs of one fixed shape
    (``UPSAMPLE_GEMM_ROWS`` x Cin, the last zero-filled) on fresh
    buffers, so the library picks one algorithm for all of them and a
    pixel's products do not depend on how many pixels the call holds: a
    row band gives its rows the full plane's bits, and a batch its
    images the bits of serving them alone."""
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    rows = n * h * wd
    chunks = -(-rows // UPSAMPLE_GEMM_ROWS)
    a = x.new_zeros((chunks * UPSAMPLE_GEMM_ROWS, cin))
    a[:rows] = x.reshape(rows, cin)
    wt = w.permute(2, 0, 1, 3).reshape(cin, 9 * cout).contiguous()
    t = torch.cat([torch.matmul(c, wt)
                   for c in a.split(UPSAMPLE_GEMM_ROWS)])
    return t[:rows].reshape(n, h, wd, 3, 3, cout)


def upsample2x_conv3x3_fused(x: torch.Tensor, w: torch.Tensor
                             ) -> torch.Tensor:
    """The phase-decomposed equivalent, 9 MACs per 4 outputs:

        z[2i, 2j]     = w[1,1] x[i,j]
        z[2i, 2j+1]   = w[1,0] x[i,j] + w[1,2] x[i,j+1]
        z[2i+1, 2j]   = w[0,1] x[i,j] + w[2,1] x[i+1,j]
        z[2i+1, 2j+1] = w[0,0] x[i,j] + w[0,2] x[i,j+1]
                      + w[2,0] x[i+1,j] + w[2,2] x[i+1,j+1]

    The nine tap products come from :func:`_tap_products`; the shifted
    sums are elementwise, in the order written."""
    n, h, wd, _ = x.shape
    t = _tap_products(x, w)

    def right(v):                  # v[i, j+1], zero past the last column
        return F.pad(v[:, :, 1:], (0, 0, 0, 1))

    def down(v):                   # v[i+1, j], zero past the last row
        return F.pad(v[:, 1:], (0, 0, 0, 0, 0, 1))

    p00 = t[..., 1, 1, :]
    p01 = t[..., 1, 0, :] + right(t[..., 1, 2, :])
    p10 = t[..., 0, 1, :] + down(t[..., 2, 1, :])
    p11 = (t[..., 0, 0, :] + right(t[..., 0, 2, :])
           + down(t[..., 2, 0, :]) + down(right(t[..., 2, 2, :])))
    top = torch.stack([p00, p01], dim=3)            # (n, h, w, 2, c)
    bot = torch.stack([p10, p11], dim=3)
    out = torch.stack([top, bot], dim=2)            # (n, h, 2, w, 2, c)
    return out.reshape(n, 2 * h, 2 * wd, -1)


def upsample_mac_counts(h: int, w: int, cin: int, cout: int) -> dict:
    """MACs of a 2x upsample and 3x3 conv of an (h, w) plane: naive (the
    conv over the zero-inserted plane) against the fused phases (1 + 2 +
    2 + 4 taps per 2x2 output block)."""
    naive = (2 * h) * (2 * w) * 9 * cin * cout
    fused = h * w * (1 + 2 + 2 + 4) * cin * cout
    return {"naive": naive, "fused": fused, "reduction": 1 - fused / naive}


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, 2 * h, 2 * w, c)
