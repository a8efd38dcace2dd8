"""K5 wrapper and the public SSD op: the chunked Mamba2 scan.

:func:`ssd_chunk` computes the intra-chunk block for every (chunk,
group, head): on a CUDA tensor it launches ``csrc/ssd_chunk.cu``, on a
CPU tensor it runs :func:`ssd_chunk_plain`.  :func:`ssd_scan` lays the
inputs out for it, then runs the inter-chunk state carry and the
inter-chunk output in torch ops, as the reference runs them in XLA.
``return_state=True`` also returns the carry's final state, which is what
prefill hands to decode.  :func:`ssd_decode_step` is the O(1) decode
step, torch ops as in the reference.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, refuse_autograd

F32 = torch.float32
KERNEL_CHUNK = 128          # the kernel's largest chunk (Lc) and d_state


def ssd_chunk_plain(c, b, xdt, scum):
    """Plain torch version of the kernel on the same operands: c, b (BC,
    G, Lc, N); xdt (BC, G, HPG, Lc, P); scum (BC, G, HPG, Lc, 1) ->
    y (BC, G, HPG, Lc, P), st (BC, G, HPG, P, N), f32."""
    lc = c.shape[2]
    cb = torch.einsum("xgtn,xgsn->xgts", c, b)[:, :, None]
    tri = torch.tril(torch.ones((lc, lc), dtype=torch.bool, device=c.device))
    # mask the exponent before exp: t < s entries are exp(+large) = inf
    arg = scum - scum.transpose(-1, -2)
    dec = torch.exp(torch.where(tri, arg, torch.full_like(arg, -torch.inf)))
    y = torch.einsum("xghts,xghsp->xghtp", cb * dec, xdt)
    bw = b[:, :, None] * torch.exp(scum[..., -1:, :] - scum)
    st = torch.einsum("xghtp,xghtn->xghpn", xdt, bw)
    return y, st


def ssd_chunk(c: torch.Tensor, b: torch.Tensor, xdt: torch.Tensor,
              scum: torch.Tensor):
    """The intra-chunk block (see :func:`ssd_chunk_plain`).  On the card
    the operands may be strided views whose innermost stride is 1 (scum's
    innermost dim has size 1); y comes back as a ``(BC, G, HPG, Lc, P)``
    view of memory laid out ``(BC, Lc, G, HPG, P)``, the order the
    caller's ``(B, nc, Lc, H, P)`` sum reads.  The kernel has no
    backward: operands that require grad are refused on both devices."""
    refuse_autograd("ssd_chunk", c, b, xdt, scum)
    BC, G, Lc, N = c.shape
    if (xdt.dim() != 5 or tuple(b.shape) != (BC, G, Lc, N)
            or tuple(xdt.shape[:2]) != (BC, G) or xdt.shape[3] != Lc
            or tuple(scum.shape) != tuple(xdt.shape[:4]) + (1,)):
        raise ValueError(f"ssd_chunk: shapes c{tuple(c.shape)} "
                         f"b{tuple(b.shape)} xdt{tuple(xdt.shape)} "
                         f"scum{tuple(scum.shape)}")
    HPG, P = xdt.shape[2], xdt.shape[4]
    if c.device.type == "cpu":
        return ssd_chunk_plain(c, b, xdt, scum)
    if c.device.type != "cuda":
        raise ValueError(f"ssd_chunk: unsupported device {c.device}")
    for t in (c, b, xdt, scum):
        if t.device != c.device or t.dtype != F32:
            raise ValueError("ssd_chunk takes f32 tensors on one device")
    if c.stride(-1) != 1 or b.stride(-1) != 1 or xdt.stride(-1) != 1:
        raise ValueError("ssd_chunk takes views whose innermost stride is 1")
    if Lc > KERNEL_CHUNK or N > KERNEL_CHUNK or P > 64:
        raise ValueError(f"ssd_chunk kernel takes Lc <= 128, N <= 128 and "
                         f"P <= 64, got Lc={Lc} N={N} P={P}")
    y = torch.empty((BC, Lc, G, HPG, P), device=c.device,
                    dtype=F32).permute(0, 2, 3, 1, 4)
    st = torch.empty((BC, G, HPG, P, N), device=c.device, dtype=F32)
    strides = (ctypes.c_longlong * 18)(
        *c.stride()[:3], *b.stride()[:3], *xdt.stride()[:4],
        *scum.stride()[:4], *y.stride()[:4])
    lib = build.library()
    build.check(lib.ssd_chunk_f32(
        c.data_ptr(), b.data_ptr(), xdt.data_ptr(), scum.data_ptr(),
        y.data_ptr(), st.data_ptr(), strides, BC, G, HPG, Lc, N, P,
        build.stream_handle(c.device)), "ssd_chunk_f32")
    ssd_chunk.launches += 1
    return y, st


ssd_chunk.launches = 0


def chunk_operands(x, dt, A, Bm, Cm, chunk: int):
    """Split (B, L, ...) into chunks of ``Lc = min(chunk, L)`` in f32:
    xf (B, L, H, P), scum (B, nc, Lc, H) the in-chunk cumulative
    log-decay, xdt (B, nc, Lc, H, P), Bc/Cc (B, nc, Lc, G, N)."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Lc = min(chunk, L)
    if L % Lc:
        raise ValueError(f"ssd_scan: length {L} is not a multiple of the "
                         f"chunk {Lc}")
    nc = L // Lc
    xf = x.to(F32)
    dtf = dt.to(F32)
    la = dtf * A[None, None, :]                        # (B, L, H) log-decay
    scum = torch.cumsum(la.reshape(Bsz, nc, Lc, H), dim=2)
    xdt = (xf * dtf[..., None]).reshape(Bsz, nc, Lc, H, P)
    Bc = Bm.reshape(Bsz, nc, Lc, G, N).to(F32)
    Cc = Cm.reshape(Bsz, nc, Lc, G, N).to(F32)
    return xf, scum, xdt, Bc, Cc


def chunk_carry(y_intra, st, scum, Cc, xf, D, return_state: bool):
    """The inter-chunk part of the scan: carry the chunk-end states
    ``st`` (B, nc, H, P, N) across chunks, add each chunk's inherited
    output to ``y_intra`` (B, nc, Lc, H, P) and the D skip."""
    Bsz, nc, Lc, H, P = y_intra.shape
    N = st.shape[-1]
    hpg = H // Cc.shape[3]
    # h_c = exp(s_L)^c h_{c-1} + st_c
    tot = torch.exp(scum[:, :, -1, :])                 # (B, nc, H)
    h = torch.zeros((Bsz, H, P, N), device=xf.device, dtype=F32)
    h_in = []
    for ci in range(nc):
        h_in.append(h)                                 # state entering chunk
        h = h * tot[:, ci, :, None, None] + st[:, ci]
    h_in = torch.stack(h_in, dim=1)                    # (B, nc, H, P, N)

    # y_t += exp(s_t) * C_t . h_in(chunk)
    Ch = Cc.repeat_interleave(hpg, dim=3)              # (B, nc, Lc, H, N)
    y_inter = torch.einsum("bclhn,bchpn->bclhp",
                           Ch * torch.exp(scum)[..., None], h_in)
    y = (y_intra + y_inter).reshape(Bsz, nc * Lc, H, P)
    y = y + xf * D[None, None, :, None]
    if return_state:
        return y, h
    return y


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 128, return_state: bool = False):
    """x (B, L, H, P), dt (B, L, H) (softplus applied), A (H,) negative,
    Bm/Cm (B, L, G, N), D (H,) -> y (B, L, H, P) f32, and with
    ``return_state`` also the final state (B, H, P, N).  A chunk longer
    than the kernel's ``KERNEL_CHUNK`` rows runs as tiles of
    ``KERNEL_CHUNK`` (zamba2-7b's 256 as two of 128): the chunked scan is
    the same function at any chunk length."""
    chunk = min(chunk, KERNEL_CHUNK)
    xf, scum, xdt, Bc, Cc = chunk_operands(x, dt, A, Bm, Cm, chunk)
    Bsz, nc, Lc, H, P = xdt.shape
    G, N = Bc.shape[3], Bc.shape[4]
    hpg = H // G

    # kernel layout (BC, G, [HPG,] ...): views, no copies
    BC = Bsz * nc
    c_k = Cc.permute(0, 1, 3, 2, 4).reshape(BC, G, Lc, N)
    b_k = Bc.permute(0, 1, 3, 2, 4).reshape(BC, G, Lc, N)
    xdt_k = xdt.permute(0, 1, 3, 2, 4).reshape(BC, G, hpg, Lc, P)
    scum_k = scum.permute(0, 1, 3, 2).reshape(BC, G, hpg, Lc, 1)
    y_intra, st = ssd_chunk(c_k, b_k, xdt_k, scum_k)
    y_intra = y_intra.reshape(Bsz, nc, H, Lc, P).permute(0, 1, 3, 2, 4)
    st = st.reshape(Bsz, nc, H, P, N)                  # chunk-local end state
    return chunk_carry(y_intra, st, scum, Cc, xf, D, return_state)


def ssd_decode_step(h, x_t, dt_t, A, B_t, C_t, D):
    """One token: h (B, H, P, N), x_t (B, H, P), dt_t (B, H), A (H,),
    B_t/C_t (B, G, N), D (H,) -> (new h, y (B, H, P))."""
    hpg = x_t.shape[1] // B_t.shape[1]
    Bh = B_t.repeat_interleave(hpg, dim=1)             # (B, H, N)
    Ch = C_t.repeat_interleave(hpg, dim=1)
    a = torch.exp(dt_t * A[None, :])                   # (B, H)
    h = h * a[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", x_t * dt_t[..., None], Bh)
    y = torch.einsum("bhpn,bhn->bhp", h, Ch) + x_t * D[None, :, None]
    return h, y
