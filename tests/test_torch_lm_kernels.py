"""K4 (flash attention) and K5 (SSD chunk) of repro_torch against the JAX
reference on the CPU.

Each wrapper runs its plain torch version here.  Tolerances are the
reference's own (tests/test_kernels.py): 2e-3 for flash attention
against the Pallas kernel in interpret mode and the dense oracle, 3e-3
for the SSD scan against the Pallas kernel and the sequential
recurrence, 2e-3 for the decode step, 1e-3 for decode attention.  The
final state of ``ssd_scan(return_state=True)`` is held against the
reference's plain chunked scan at 1e-4 (the same f32 arithmetic, summed
in another order).  tests/test_torch_cuda.py holds the CUDA kernels
against these plain versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention.ops import decode_attention as j_decode
from repro.kernels.flash_attention.ref import mha_reference as j_mha
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan.kernel import ssd_chunk as j_ssd_chunk
from repro.kernels.ssd_scan.ops import ssd_decode_step as j_decode_step
from repro.kernels.ssd_scan.ref import ssd_reference as j_ssd_reference
from repro.models.lm.ssm import _ssd_xla as j_ssd_xla
from repro_torch import kernels
from repro_torch.kernels.flash_attention import (
    decode_attention, flash_attention, flash_attention_padded,
    flash_attention_plain)
from repro_torch.kernels.flash_attention.ref import mha_reference
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels.flash_attention.ops import wgmma_geometry
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_decode_step, ssd_scan
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_reference

torch.set_num_threads(2)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(seed, B, Hq, Hkv, L, D):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (B, Hq, L, D), 0.3), _normal(rng, (B, Hkv, L, D), 0.3),
            _normal(rng, (B, Hkv, L, D)))


ATTN_SHAPES = [(1, 4, 4, 64, 16), (2, 8, 2, 257, 32), (1, 6, 6, 100, 64),
               (2, 4, 1, 128, 32)]


class TestFlashAttention:
    @pytest.mark.parametrize("shape", ATTN_SHAPES)
    @pytest.mark.parametrize("causal", [True, False])
    def test_plain_matches_pallas_kernel(self, shape, causal):
        q, k, v = _qkv(sum(shape), *shape)
        got = flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
        want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  interpret=True))
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)
        oracle = mha_reference(_t(q), _t(k), _t(v), causal=causal).numpy()
        np.testing.assert_allclose(got, oracle, atol=2e-3, rtol=2e-3)

    def test_kv_len_mask_matches_reference_oracle(self):
        """Columns past kv_len are masked, as in the Pallas kernel's
        padded call and the dense oracle."""
        q, k, v = _qkv(5, 1, 4, 2, 48, 16)
        got = flash_attention_padded(_t(q), _t(k), _t(v), sm_scale=0.25,
                                     causal=False, kv_len=37).numpy()
        want = np.asarray(j_mha(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), sm_scale=0.25, causal=False,
                                kv_len=37))
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)

    def test_bf16_in_bf16_out(self):
        q, k, v = _qkv(7, 1, 4, 2, 40, 24)
        bf = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
        got = flash_attention(*bf)
        assert got.dtype == torch.bfloat16
        want = flash_attention_plain(*(t.float() for t in bf),
                                     sm_scale=24 ** -0.5, causal=True,
                                     kv_len=40)
        # one bf16 rounding of the f32 result: half an ulp, 2**-9 relative
        np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                                   atol=1e-6, rtol=2.0 ** -8)

    def test_decode_attention(self):
        rng = np.random.default_rng(0)
        B, H, K, S, D = 2, 8, 2, 64, 32
        q, kc, vc = (_normal(rng, (B, H, 1, D)), _normal(rng, (B, K, S, D)),
                     _normal(rng, (B, K, S, D)))
        for cache_len in (S, 23):
            got = decode_attention(_t(q), _t(kc), _t(vc), cache_len).numpy()
            want = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), cache_len))
            np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def _ssd_inputs(seed, Bz, L, H, P, G, N):
    rng = np.random.default_rng(seed)
    x = _normal(rng, (Bz, L, H, P))
    dt = np.log1p(np.exp(_normal(rng, (Bz, L, H)))).astype(np.float32) * 0.5
    A = -np.exp(_normal(rng, (H,), 0.3))
    Bm = _normal(rng, (Bz, L, G, N), 0.3)
    Cm = _normal(rng, (Bz, L, G, N), 0.3)
    D = _normal(rng, (H,))
    return x, dt, A, Bm, Cm, D


SSD_SHAPES = [(1, 64, 2, 8, 1, 16), (2, 256, 4, 16, 2, 24),
              (1, 128, 8, 32, 1, 64)]


class TestSSD:
    @pytest.mark.parametrize("shape", SSD_SHAPES)
    @pytest.mark.parametrize("chunk", [32, 64])
    def test_scan_matches_pallas_and_recurrence(self, shape, chunk):
        args = _ssd_inputs(sum(shape) + chunk, *shape)
        got = ssd_scan(*(_t(a) for a in args), chunk=chunk).numpy()
        jargs = [jnp.asarray(a) for a in args]
        want = np.asarray(j_ssd_scan(*jargs, chunk=chunk, interpret=True))
        np.testing.assert_allclose(got, want, atol=3e-3, rtol=3e-3)
        oracle = np.asarray(j_ssd_reference(*jargs))
        np.testing.assert_allclose(got, oracle, atol=3e-3, rtol=3e-3)
        mine = ssd_reference(*(_t(a) for a in args)).numpy()
        np.testing.assert_allclose(mine, oracle, atol=3e-3, rtol=3e-3)

    @pytest.mark.parametrize("dims", [(2, 1, 3, 16, 8, 12),
                                      (3, 2, 2, 32, 16, 8)])
    def test_chunk_plain_matches_pallas_kernel(self, dims):
        BC, G, HPG, Lc, N, P = dims
        rng = np.random.default_rng(BC * Lc)
        c, b = _normal(rng, (BC, G, Lc, N), 0.3), _normal(rng, (BC, G, Lc, N), 0.3)
        xdt = _normal(rng, (BC, G, HPG, Lc, P))
        la = -np.abs(_normal(rng, (BC, G, HPG, Lc, 1), 0.4))
        scum = np.cumsum(la, axis=3).astype(np.float32)
        y, st = ssd_chunk(_t(c), _t(b), _t(xdt), _t(scum))
        jy, jst = j_ssd_chunk(*(jnp.asarray(a) for a in (c, b, xdt, scum)),
                              interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=3e-3,
                                   rtol=3e-3)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=3e-3,
                                   rtol=3e-3)

    @pytest.mark.parametrize("chunk", [16, 64])
    def test_final_state_matches_reference_scan(self, chunk):
        args = _ssd_inputs(11, 2, 64, 4, 8, 2, 12)
        y, h = ssd_scan(*(_t(a) for a in args), chunk=chunk,
                        return_state=True)
        jy, jh = jax.jit(lambda *a: j_ssd_xla(*a, chunk=chunk,
                                              return_state=True))(
            *(jnp.asarray(a) for a in args))
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4,
                                   rtol=1e-4)

    def test_decode_step(self):
        Bz, L, H, P, G, N = 2, 16, 4, 8, 2, 12
        x, dt, A, Bm, Cm, D = _ssd_inputs(3, Bz, L, H, P, G, N)
        h = torch.zeros((Bz, H, P, N))
        jh = jnp.zeros((Bz, H, P, N))
        jstep = jax.jit(j_decode_step)
        for t in range(L):
            h, y = ssd_decode_step(h, _t(x[:, t]), _t(dt[:, t]), _t(A),
                                   _t(Bm[:, t]), _t(Cm[:, t]), _t(D))
            jh, jy = jstep(jh, *(jnp.asarray(a) for a in (
                x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D)))
            np.testing.assert_allclose(y.numpy(), np.asarray(jy),
                                       atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=2e-3,
                                   rtol=2e-3)

    def test_chunk_reads_permuted_views(self):
        """ssd_scan hands the kernel views of chunk_operands' tensors (no
        copies): the same y and st as on contiguous copies of them."""
        Bz, L, H, P, G, N, Lc = 2, 64, 4, 8, 2, 12, 16
        xf, scum, xdt, Bc, Cc = ssd_ops.chunk_operands(
            *(_t(a) for a in _ssd_inputs(5, Bz, L, H, P, G, N)[:5]), Lc)
        BC, hpg = Bz * L // Lc, H // G
        views = (Cc.permute(0, 1, 3, 2, 4).reshape(BC, G, Lc, N),
                 Bc.permute(0, 1, 3, 2, 4).reshape(BC, G, Lc, N),
                 xdt.permute(0, 1, 3, 2, 4).reshape(BC, G, hpg, Lc, P),
                 scum.permute(0, 1, 3, 2).reshape(BC, G, hpg, Lc, 1))
        assert not any(v.is_contiguous() for v in views)
        assert all(v.stride(-1) == 1 for v in views[:3])
        assert views[2].data_ptr() == xdt.data_ptr()
        got = ssd_chunk(*views)
        want = ssd_chunk(*(v.contiguous() for v in views))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)

    def test_ragged_length_raises(self):
        args = _ssd_inputs(0, 1, 48, 2, 8, 1, 8)
        with pytest.raises(ValueError, match="multiple of the chunk"):
            ssd_scan(*(_t(a) for a in args), chunk=32)


def _split(x):
    """The kernels' split (tf32x3::split): hi = x truncated to TF32 (13
    low bits dropped), lo = x - hi truncated as the tensor cores read it."""
    hi = (x.view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, (((x - hi).view(torch.int32)) & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """a @ b as K5 issues it: hi·lo + lo·hi + hi·hi of the split operands,
    summed exactly, rounded to the f32 accumulator."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return sum(x.double() @ y.double()
               for x, y in ((ah, bl), (al, bh), (ah, bh))).float()


def test_three_products_meet_k5_tolerance():
    """K5's premise at the Zamba2 chunk (Lc 128, N 64, P 64): cb, y and st
    each as three products of hi + lo TF32 pairs, W formed in f32 between
    them, within 3e-3 of the block computed in f64."""
    rng = np.random.default_rng(0)
    Lc, N, P = 128, 64, 64
    c = torch.from_numpy(rng.standard_normal((Lc, N)).astype(np.float32) * .5)
    b = torch.from_numpy(rng.standard_normal((Lc, N)).astype(np.float32) * .5)
    xdt = torch.from_numpy(rng.standard_normal((Lc, P)).astype(np.float32)
                           * .5)
    scum = torch.cumsum(-torch.from_numpy(
        rng.uniform(size=(Lc, 1)).astype(np.float32)), dim=0)
    want_y, want_st = ssd_ops.ssd_chunk_plain(
        *(t.double()[None, None] for t in (c, b)),
        *(t.double()[None, None, None] for t in (xdt, scum)))
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool))
    arg = torch.where(tri, scum - scum.T, torch.full((Lc, Lc), -torch.inf))
    w = _mm3(c, b.T) * torch.exp(arg)
    y = _mm3(w, xdt)
    st = _mm3((xdt * torch.exp(scum[-1] - scum)).T.contiguous(), b)
    torch.testing.assert_close(y.double(), want_y[0, 0, 0], atol=3e-3,
                               rtol=3e-3)
    torch.testing.assert_close(st.double(), want_st[0, 0, 0], atol=3e-3,
                               rtol=3e-3)


def _meta_calls():
    meta = dict(device=torch.device("meta"), dtype=torch.float32)
    return {
        "flash_attention_padded": lambda: flash_attention_padded(
            torch.empty((1, 2, 8, 16), **meta),
            torch.empty((1, 1, 8, 16), **meta),
            torch.empty((1, 1, 8, 16), **meta), sm_scale=0.25, causal=True,
            kv_len=8),
        "ssd_chunk": lambda: ssd_chunk(
            torch.empty((2, 1, 8, 4), **meta), torch.empty((2, 1, 8, 4), **meta),
            torch.empty((2, 1, 3, 8, 5), **meta),
            torch.empty((2, 1, 3, 8, 1), **meta)),
    }


@pytest.mark.parametrize("name", sorted(_meta_calls()))
def test_wrapper_refuses_other_devices(name):
    """A CPU tensor runs the plain version; any other non-CUDA device
    raises instead of falling back, and nothing counts as a launch."""
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        _meta_calls()[name]()
    assert kernels.launch_counts()[name] == 0


def test_cpu_runs_plain_and_counts_no_launch():
    kernels.reset_launch_counts()
    q, k, v = _qkv(1, 1, 2, 1, 16, 8)
    flash_attention(_t(q), _t(k), _t(v))
    ssd_scan(*(_t(a) for a in _ssd_inputs(2, 1, 16, 2, 4, 1, 4)), chunk=8)
    counts = kernels.launch_counts()
    assert counts["flash_attention_padded"] == 0 and counts["ssd_chunk"] == 0


class TestWgmmaGeometry:
    """The bf16 tensor-core K4 takes every head dim the configs use and
    fits its shared memory; checked here in plain Python."""

    @pytest.mark.parametrize("arch", ARCH_IDS)
    def test_every_attention_config_is_taken(self, arch):
        for cfg in (get_config(arch), get_smoke_config(arch)):
            if cfg.is_attention_free:
                continue
            halves, smem = wgmma_geometry(cfg.hd)
            assert halves == (1 if cfg.hd <= 64 else 2 if cfg.hd <= 128
                              else 4)
            assert smem < 227 * 1024

    def test_head_dim_128_shared_memory(self):
        halves, smem = wgmma_geometry(128)
        assert halves == 2 and smem == 5 * 2 * 64 * 128 + 1024 + 40
        assert smem < 227 * 1024

    def test_head_dim_224_shared_memory(self):
        """Zamba2-7B's heads: four 64-column boxes, Q and a 2-stage K/V
        ring in 164,904 bytes, under the 227 KB a block may use."""
        halves, smem = wgmma_geometry(224)
        assert halves == 4 and smem == 5 * 4 * 64 * 128 + 1024 + 40
        assert smem == 164_904 < 227 * 1024

    @pytest.mark.parametrize("head_dim", [0, 4, 20, 100, 264])
    def test_other_head_dims_raise(self, head_dim):
        with pytest.raises(ValueError, match="multiple of 8"):
            wgmma_geometry(head_dim)
