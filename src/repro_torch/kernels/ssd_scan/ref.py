"""Naive sequential recurrence, the SSD oracle (Mamba2, arXiv:2405.21060).

Per timestep t, with state h (H, P, N) per batch element:
    a_t = exp(dt_t * A_h)
    h_t = a_t * h_{t-1} + dt_t * x_t (outer) B_t
    y_t = h_t . C_t + D_h * x_t
Head h uses the B/C group h // (H // G).
"""
from __future__ import annotations

import torch


def ssd_reference(x, dt, A, Bm, Cm, D) -> torch.Tensor:
    """x (B, L, H, P), dt (B, L, H), A (H,), Bm/Cm (B, L, G, N), D (H,)."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    Bh = Bm.repeat_interleave(hpg, dim=2).to(torch.float32)
    Ch = Cm.repeat_interleave(hpg, dim=2).to(torch.float32)
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        a = torch.exp(dtf[:, t] * A[None, :])
        h = h * a[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", xf[:, t] * dtf[:, t, :, None], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1)
    return y + xf * D[None, None, :, None]
