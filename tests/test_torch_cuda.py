"""The CUDA kernels of repro_torch against their plain torch versions on
the same card tensors (marked ``cuda``; they skip without a GPU).  This
file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import winograd as wg
from repro_torch.data import cc_cases
from repro_torch.kernels.bfp_matmul import (
    bfp_matmul_quantized, bfp_matmul_quantized_plain, quantize_operands)
from repro_torch.kernels.cc_label import (
    cc_label_tiled, local_spread_converge, local_spread_converge_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_padded,
                                                 flash_attention_plain)
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_plain, ssd_scan
from repro_torch.kernels.winograd_conv import (
    winograd_conv2d, winograd_tiles, winograd_tiles_plain)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _maps(seed, n, h, w, p_link=0.5):
    rng = np.random.default_rng(seed)
    score = rng.uniform(0.0, 1.0, (n, h, w)).astype(np.float32)
    links = (rng.uniform(0.0, 1.0, (n, h, w, 8)) < p_link).astype(np.float32)
    return score, links


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnCard:
    """CUDA kernel against its plain version on the same card tensors."""

    def test_winograd_kernel(self):
        dev = _cuda()
        x = torch.from_numpy(_normal(0, (2, 37, 29, 19))).to(dev)
        w = torch.from_numpy(_normal(1, (3, 3, 19, 45))).to(dev)
        b = torch.from_numpy(_normal(2, (45,))).to(dev)
        got = winograd_conv2d(x, w, b, relu=True)
        u = wg.transform_weights(w).reshape(36, 19, 45)
        want = winograd_tiles_plain(x.cpu(), u.cpu(), b.cpu(),
                                    padding="SAME", relu=True)
        torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)
        assert winograd_tiles.launches >= 1

    @pytest.mark.parametrize("shape,padding,transposed", [
        ((2, 64, 64, 3, 64), "SAME", False),     # conv1_1's Cin 3
        ((1, 37, 29, 3, 5), "VALID", False),     # Cin 3, odd Cout, ragged
        ((2, 33, 50, 24, 45), "SAME", True),     # transposed weights
        ((1, 19, 21, 64, 72), "VALID", True),    # Cout past one block
        ((2, 32, 32, 512, 512), "SAME", False),  # conv5_1: 16-tile blocks
        ((1, 130, 70, 40, 33), "SAME", False)])  # 32-tile blocks, ragged
    def test_winograd_kernel_geometry(self, shape, padding, transposed):
        """Every shape the engine sends K1: channel counts off the MMA
        tile (scalar and 16-byte loads), ragged tile rows and columns,
        both paddings, the transposed image mode's weights (a strided
        view), both block sizes; against the plain version on CPU copies."""
        dev = _cuda()
        n, h, w, cin, cout = shape
        x = torch.from_numpy(_normal(h, (n, h, w, cin))).to(dev)
        k = torch.from_numpy(_normal(w, (3, 3, cin, cout))
                             * (2.0 / (9 * cin)) ** 0.5).to(dev)
        if transposed:
            k = k.transpose(0, 1)
        b = torch.from_numpy(_normal(cout, (cout,))).to(dev)
        got = winograd_conv2d(x, k, b, padding=padding, relu=True)
        u = wg.transform_weights(k.cpu()).reshape(36, cin, cout)
        want = winograd_tiles_plain(x.cpu(), u, b.cpu(), padding=padding,
                                    relu=True)
        assert got.shape == want.shape
        torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)

    def test_bfp_matmul_kernel(self):
        dev = _cuda()
        ops = quantize_operands(torch.from_numpy(_normal(0, (130, 528))).to(dev),
                                torch.from_numpy(_normal(1, (528, 70))).to(dev))
        got = bfp_matmul_quantized(*ops)
        want = bfp_matmul_quantized_plain(*ops, block_size=32,
                                          mantissa_bits=10)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("mkn", [(130, 37, 70), (257, 200, 9),
                                     (2048, 640, 128), (64, 33, 17),
                                     (1000, 96, 16), (300, 515, 100),
                                     (9000, 40, 33)])
    @pytest.mark.parametrize("block_size", [16, 32])
    @pytest.mark.parametrize("mantissa_bits", [7, 10])
    def test_bfp_matmul_ragged(self, mkn, block_size, mantissa_bits):
        """Ragged M, N and K (K % 8 != 0 takes the scalar loads), N = 9,
        1, 2, 4 and 8 K splits, both block sizes and widths, and an
        all-zero block in A and B."""
        dev = _cuda()
        M, K, N = mkn
        a = _normal(M + K, (M, K)) * 4.0
        b = _normal(K + N, (K, N))
        a[:, :block_size] = 0.0          # all-zero blocks of every row
        b[block_size: 2 * block_size] = 0.0
        ops = quantize_operands(torch.from_numpy(a).to(dev),
                                torch.from_numpy(b).to(dev),
                                block_size=block_size,
                                mantissa_bits=mantissa_bits)
        geo = dict(block_size=block_size, mantissa_bits=mantissa_bits)
        got = bfp_matmul_quantized(*ops, **geo)
        want = bfp_matmul_quantized_plain(*ops, **geo)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("mantissa_bits", [11, 13, 15])
    def test_bfp_matmul_refuses_wide_mantissas(self, mantissa_bits):
        """11-15 bits (hi + lo TF32 terms) against the plain version at
        merge1_c1's shape and a ragged one, with a 1x1 conv's scales (unit
        activations, He weights: |C| about 1); 16 bits (past int16)
        refused.  Above 10 bits the products are no longer exact in f32,
        so the sum order alone moves C by about 2^-24 |C| sqrt(K)."""
        dev = _cuda()
        for M, K, N in ((2048, 640, 128), (257, 200, 9)):
            a = torch.from_numpy(_normal(M, (M, K))).to(dev)
            b = torch.from_numpy(_normal(N, (K, N)) * (2.0 / K) ** 0.5).to(dev)
            ops = quantize_operands(a, b, mantissa_bits=mantissa_bits)
            geo = dict(block_size=32, mantissa_bits=mantissa_bits)
            got = bfp_matmul_quantized(*ops, **geo)
            want = bfp_matmul_quantized_plain(*ops, **geo)
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        with pytest.raises(ValueError, match="mantissa_bits <= 15"):
            bfp_matmul_quantized(*ops, block_size=32, mantissa_bits=16)

    def test_cc_kernel(self):
        dev = _cuda()
        score, links = _maps(3, 2, 64, 96, 0.7)
        s, l = torch.from_numpy(score).to(dev), torch.from_numpy(links).to(dev)
        got = cc_label_tiled(s, l, return_stats=True)
        want = cc_label_tiled(s.cpu(), l.cpu(), return_stats=True)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        assert local_spread_converge.launches >= 1

    @pytest.mark.parametrize("name", cc_cases.CASES)
    @pytest.mark.parametrize("th,tw", [(8, 8), (8, 24), (32, 32)])
    def test_cc_kernel_adversarial(self, name, th, tw):
        """The scan kernel's labels bit-equal to the plain Jacobi loop's on
        links that are not symmetric, dirty labels (negative ones and
        labels on non-positive pixels) and a serpentine in every tile."""
        dev = _cuda()
        args = [torch.from_numpy(a) for a in cc_cases.make_case(
            name, th + tw, 2, 3 * th, 2 * tw, th, tw)]
        local_spread_converge.launches = 0
        got = local_spread_converge(*(a.to(dev) for a in args), th=th, tw=tw)
        want = local_spread_converge_plain(*args, th=th, tw=tw)
        assert torch.equal(got.cpu(), want)
        assert local_spread_converge.launches == 1

    def test_cc_kernel_refuses_unaligned_links(self):
        dev = _cuda()
        lab = torch.zeros((1, 8, 8), dtype=torch.int32, device=dev)
        lnk = torch.zeros(8 * 8 * 8 + 1, dtype=torch.int32,
                          device=dev)[1:].view(1, 8, 8, 8)
        with pytest.raises(ValueError, match="aligned"):
            local_spread_converge(lab, lab, lnk, th=8, tw=8)

    @pytest.mark.parametrize("D", [30, 64, 80, 100, 128])
    @pytest.mark.parametrize("L,group", [(257, 4), (1000, 1)])
    def test_flash_attention_f32_tensor_cores(self, D, L, group):
        """The 3xTF32 kernel at head dims on and off its 16-column
        instances (30: 4-byte copies), GQA 4 and MHA, lengths off the
        64-row KV tile; causal, then non-causal with kv_len < L; at the
        Zamba2 prefill's scale (q and k x2, v x32: a sharp softmax), where
        one TF32 term would miss the f32 tolerance."""
        dev = _cuda()
        B, Hkv = 2, 2
        Hq = Hkv * group
        q = torch.from_numpy(_normal(D, (B, Hq, L, D)) * 2).to(dev)
        k = torch.from_numpy(_normal(L, (B, Hkv, L, D)) * 2).to(dev)
        v = torch.from_numpy(_normal(7, (B, Hkv, L, D)) * 32).to(dev)
        for causal, kv_len in ((True, L), (False, L - 70)):
            geo = dict(sm_scale=D ** -0.5, causal=causal, kv_len=kv_len)
            got = flash_attention_padded(q, k, v, **geo)
            want = flash_attention_plain(q, k, v, **geo)
            torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)

    @pytest.mark.parametrize("shape,dtype,causal,tol", [
        ((2, 8, 2, 257, 32), torch.float32, True, 2e-3),
        ((1, 6, 6, 100, 80), torch.float32, False, 2e-3),
        ((2, 4, 1, 70, 128), torch.bfloat16, True, 1.6e-2),
        ((1, 4, 4, 64, 16), torch.bfloat16, False, 1.6e-2)])
    def test_flash_attention_kernel(self, shape, dtype, causal, tol):
        dev = _cuda()
        B, Hq, Hkv, L, D = shape
        q = torch.from_numpy(_normal(0, (B, Hq, L, D)) * 0.5).to(dev, dtype)
        k = torch.from_numpy(_normal(1, (B, Hkv, L, D)) * 0.5).to(dev, dtype)
        v = torch.from_numpy(_normal(2, (B, Hkv, L, D))).to(dev, dtype)
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, sm_scale=D ** -0.5,
                                     causal=causal, kv_len=L)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        # a kv_len below the length masks the columns past it
        got = flash_attention_padded(q, k, v, sm_scale=0.3, causal=False,
                                     kv_len=L // 2)
        want = flash_attention_plain(q, k, v, sm_scale=0.3, causal=False,
                                     kv_len=L // 2)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)

    @pytest.mark.parametrize("D", [24, 64, 80, 112, 128])
    @pytest.mark.parametrize("L,group", [(257, 4), (1000, 8)])
    def test_flash_attention_bf16_tensor_cores(self, D, L, group):
        """The wgmma kernel at every head dim of the configs, lengths that
        are not a multiple of the 64-row KV tile, GQA groups 4 and 8;
        causal, then non-causal with kv_len < L."""
        dev = _cuda()
        B, Hkv = 2, 2
        Hq = Hkv * group
        q = torch.from_numpy(_normal(D, (B, Hq, L, D))).to(dev, torch.bfloat16)
        k = torch.from_numpy(_normal(L, (B, Hkv, L, D))).to(dev,
                                                           torch.bfloat16)
        v = torch.from_numpy(_normal(7, (B, Hkv, L, D))).to(dev,
                                                           torch.bfloat16)
        for causal, kv_len in ((True, L), (False, L - 70)):
            geo = dict(sm_scale=D ** -0.5, causal=causal, kv_len=kv_len)
            got = flash_attention_padded(q, k, v, **geo)
            want = flash_attention_plain(q, k, v, **geo)
            torch.testing.assert_close(got.float(), want.float(), atol=1.6e-2,
                                       rtol=1.6e-2)

    @pytest.mark.parametrize("D", [64, 80, 128])
    def test_flash_attention_bf16_sharp_softmax(self, D):
        """Scores and values at the Zamba2 prefill's scale (|v| up to ~50,
        a nearly one-hot softmax): a weight of P rounded to bf16 alone
        moves outputs near 0 past the tolerance, so P must reach P.V with
        more than bf16's 8 significant bits."""
        dev = _cuda()
        B, Hq, Hkv, L = 1, 8, 2, 512
        q = torch.from_numpy(_normal(D, (B, Hq, L, D)) * 2).to(dev,
                                                               torch.bfloat16)
        k = torch.from_numpy(_normal(L, (B, Hkv, L, D)) * 2).to(dev,
                                                                torch.bfloat16)
        v = torch.from_numpy(_normal(7, (B, Hkv, L, D)) * 32).to(dev,
                                                                 torch.bfloat16)
        geo = dict(sm_scale=D ** -0.5, causal=True, kv_len=L)
        got = flash_attention_padded(q, k, v, **geo)
        want = flash_attention_plain(q, k, v, **geo)
        torch.testing.assert_close(got.float(), want.float(), atol=1.6e-2,
                                   rtol=1.6e-2)

    def test_flash_attention_bf16_geometry_and_refusals(self):
        dev = _cuda()
        for D in (20, 136):      # not a multiple of 8; above 128
            x = torch.zeros((1, 1, 64, D), device=dev, dtype=torch.bfloat16)
            with pytest.raises(ValueError):
                flash_attention(x, x, x)

    @pytest.mark.parametrize("dims", [(3, 2, 3, 32, 16, 24),
                                      (2, 1, 80, 128, 64, 64),
                                      (2, 1, 4, 120, 128, 64),
                                      (1, 1, 2, 8, 16, 16),
                                      (2, 2, 5, 72, 40, 20),
                                      (3, 1, 3, 100, 8, 36),
                                      (1, 1, 3, 128, 128, 7)])
    def test_ssd_chunk_kernel(self, dims):
        """Contiguous operands; N and P off the 16-column tile (scalar
        copies where rows are not 16-byte multiples), Lc below 128."""
        dev = _cuda()
        BC, G, HPG, Lc, N, P = dims
        c = torch.from_numpy(_normal(0, (BC, G, Lc, N)) * 0.3).to(dev)
        b = torch.from_numpy(_normal(1, (BC, G, Lc, N)) * 0.3).to(dev)
        xdt = torch.from_numpy(_normal(2, (BC, G, HPG, Lc, P))).to(dev)
        la = -torch.from_numpy(np.abs(_normal(3, (BC, G, HPG, Lc, 1)))).to(dev)
        scum = torch.cumsum(la, dim=3)
        got = ssd_chunk(c, b, xdt, scum)
        want = ssd_chunk_plain(c, b, xdt, scum)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=3e-3, rtol=3e-3)

    @pytest.mark.parametrize("shape", [(2, 256, 8, 64, 2, 64, 128),
                                       (1, 192, 6, 20, 3, 12, 64),
                                       (2, 96, 4, 16, 1, 24, 32)])
    def test_ssd_chunk_strided_views(self, shape):
        """The kernel reads ssd_scan's views of chunk_operands' tensors in
        place (rows H * P apart, scum H apart) and gives the same y and st
        as on contiguous copies; y comes back in (B, nc, Lc, H, P) memory
        order."""
        from repro_torch.kernels.ssd_scan import ops as ssd_ops

        dev = _cuda()
        Bz, L, H, P, G, N, Lc = shape
        x = torch.from_numpy(_normal(0, (Bz, L, H, P))).to(dev)
        dt = torch.nn.functional.softplus(
            torch.from_numpy(_normal(1, (Bz, L, H))).to(dev)) * 0.5
        A = -torch.exp(torch.from_numpy(_normal(2, (H,))) * 0.3).to(dev)
        Bm = torch.from_numpy(_normal(3, (Bz, L, G, N)) * 0.3).to(dev)
        Cm = torch.from_numpy(_normal(4, (Bz, L, G, N)) * 0.3).to(dev)
        _, scum, xdt, Bc, Cc = ssd_ops.chunk_operands(x, dt, A, Bm, Cm, Lc)
        BC, hpg = Bz * L // Lc, H // G
        views = (Cc.permute(0, 1, 3, 2, 4).reshape(BC, G, Lc, N),
                 Bc.permute(0, 1, 3, 2, 4).reshape(BC, G, Lc, N),
                 xdt.permute(0, 1, 3, 2, 4).reshape(BC, G, hpg, Lc, P),
                 scum.permute(0, 1, 3, 2).reshape(BC, G, hpg, Lc, 1))
        assert views[2].data_ptr() == xdt.data_ptr()
        y, st = ssd_chunk(*views)
        y2, st2 = ssd_chunk(*(v.contiguous() for v in views))
        torch.testing.assert_close(y, y2, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(st, st2, atol=1e-6, rtol=1e-6)
        assert y.permute(0, 3, 1, 2, 4).is_contiguous()
        wy, wst = ssd_chunk_plain(*(v.cpu() for v in views))
        torch.testing.assert_close(y.cpu(), wy, atol=3e-3, rtol=3e-3)
        torch.testing.assert_close(st.cpu(), wst, atol=3e-3, rtol=3e-3)

    def test_ssd_scan_state_on_card(self):
        """The scan with K5 and its final state against the CPU run."""
        dev = _cuda()
        Bz, L, H, P, G, N = 2, 96, 4, 16, 2, 8
        x = torch.from_numpy(_normal(0, (Bz, L, H, P)))
        dt = torch.nn.functional.softplus(
            torch.from_numpy(_normal(1, (Bz, L, H)))) * 0.5
        A = -torch.exp(torch.from_numpy(_normal(2, (H,))) * 0.3)
        Bm = torch.from_numpy(_normal(3, (Bz, L, G, N)) * 0.3)
        Cm = torch.from_numpy(_normal(4, (Bz, L, G, N)) * 0.3)
        D = torch.from_numpy(_normal(5, (H,)))
        args = (x, dt, A, Bm, Cm, D)
        got = ssd_scan(*(a.to(dev) for a in args), chunk=32,
                       return_state=True)
        want = ssd_scan(*args, chunk=32, return_state=True)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, atol=3e-3, rtol=3e-3)

    @pytest.mark.parametrize("capacity", [4, 64])
    def test_boxes_fn_on_card_without_sync(self, capacity):
        """The device box tail on the card equals its CPU run bit for bit,
        and raises nothing under sync debug mode "error"."""
        dev = _cuda()
        from repro_torch.models.fcn import postprocess as pp

        score, links = _maps(7, 3, 40, 36)
        labels = pp.cc_label_batched(torch.from_numpy(score),
                                     torch.from_numpy(links))
        want = pp.boxes_from_labels_batched_torch(labels, capacity)
        on_card = labels.to(dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = pp.boxes_from_labels_batched_torch(on_card, capacity)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for g, w in zip(got, want):
            assert g.device.type == "cuda"
            assert torch.equal(g.cpu(), w)

    @pytest.mark.parametrize("precision", ["bfp", "f32"])
    def test_engine_maps_batch_invariant(self, precision):
        """An image's maps are bit-equal alone and in a batch of 4
        (full-width VGG-16 PixelLink on zero-padded requests of the 512
        bucket), so micro-batched serving returns the boxes of sequential
        serving.  The fused upsample's cuDNN convs once took another
        algorithm at batch 4, and FP16 storage carried the last-bit
        difference on to the score maps."""
        _cuda()
        from repro_torch.data.images import RequestStream
        from repro_torch.launch.serve import STDService

        svc = STDService(width=1.0, precision=precision,
                         buckets=(128, 256, 512), merge_ch=(128, 64, 32),
                         device="cuda")
        padded = [svc.preprocess(img)[0] for img in RequestStream(
            24, seed=1, hw_range=((256, 512), (256, 512))).images()]
        stack = np.stack([x for x in padded if x.shape[:2] == (512, 512)][:4])
        model = svc.factory.model((512, 512), precision)
        params = svc.factory.params((512, 512), precision)
        batch = model.apply(params, torch.from_numpy(stack).cuda())
        for i in range(len(stack)):
            alone = model.apply(params,
                                torch.from_numpy(stack[i:i + 1]).cuda())
            for k in ("score", "links", "logits"):
                assert torch.equal(batch[k][i:i + 1], alone[k]), (i, k)

    @pytest.mark.parametrize("postprocess,precision", [
        ("host", "bfp"), ("device", "bfp"), ("device", "f32")])
    def test_serve_batched_parity(self, postprocess, precision):
        """Micro-batched and pipelined serving on the card give the boxes
        of sequential serving (width 0.125; in bfp K1-K3 on every
        batch)."""
        _cuda()
        from repro_torch import kernels
        from repro_torch.data.images import RequestStream
        from repro_torch.launch.serve import STDService

        images = RequestStream(6, seed=3,
                               hw_range=((48, 64), (48, 128))).images()
        svc = STDService(width=0.125, buckets=(64, 128), max_batch=4,
                         max_wait_ms=20, precision=precision,
                         postprocess=postprocess, device="cuda")
        single = [svc(img) for img in images]
        assert svc.serve_pipelined(images) == single
        kernels.reset_launch_counts()
        assert svc.serve_batched(images) == single
        batches = svc.stats["batching"]["batches"]
        assert max(b["n"] for b in batches) >= 2
        counts = kernels.launch_counts()
        assert counts["local_spread_converge"] == len(batches)
        if precision == "bfp":
            assert counts["bfp_matmul_quantized"] == 7 * len(batches)

    @pytest.mark.parametrize("mkn,split_rows", [
        ((2 * 16384, 16, 16), 16384),     # DB's db_r1: K one ragged block
        ((2 * 16384, 16, 1), 16384),      # DB's head_logits: N = 1
        ((512, 2048, 512), 256),          # ResNet-50's s4b*_c1
        ((512, 512, 2048), 256)])         # ResNet-50's s4b*_c3
    def test_bfp_matmul_zoo_shapes(self, mkn, split_rows):
        """K2 at the DB head's and ResNet-50's deepest shapes (512x512,
        batch 2), against the plain version on CPU copies; the first
        image's rows alone give the same bits as in the batch."""
        dev = _cuda()
        M, K, N = mkn
        a = torch.relu(torch.from_numpy(_normal(M, (M, K)))).to(dev)
        b = torch.from_numpy(_normal(K + N, (K, N)) * (2.0 / K) ** 0.5).to(dev)
        ops = quantize_operands(a, b)
        got = bfp_matmul_quantized(*ops, split_rows=split_rows)
        want = bfp_matmul_quantized_plain(*(t.cpu() for t in ops),
                                          block_size=32, mantissa_bits=10)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        alone = bfp_matmul_quantized(*quantize_operands(a[:split_rows], b),
                                     split_rows=split_rows)
        assert torch.equal(alone, got[:split_rows])

    def test_winograd_kernel_cout_16(self):
        """K1 at the DB head's db_c3 (32 -> 16 channels, 128x128, batch 2)
        against the plain version on CPU copies."""
        dev = _cuda()
        x = torch.relu(torch.from_numpy(_normal(3, (2, 128, 128, 32)))).to(dev)
        w = torch.from_numpy(_normal(4, (3, 3, 32, 16))
                             * (2.0 / (9 * 32)) ** 0.5).to(dev)
        b = torch.from_numpy(_normal(5, (16,))).to(dev)
        got = winograd_conv2d(x, w, b, relu=True)
        u = wg.transform_weights(w.cpu()).reshape(36, 32, 16)
        want = winograd_tiles_plain(x.cpu(), u, b.cpu(), padding="SAME",
                                    relu=True)
        torch.testing.assert_close(got.cpu(), want, atol=2e-3, rtol=2e-3)

    @pytest.mark.parametrize("precision", ["bfp", "f32"])
    def test_resnet50_maps_batch_invariant(self, precision):
        """ResNet-50 PixelLink (``configs.RESNET50`` at 128x128): an
        image's maps are bit-equal alone and in a batch of 4.  Its seven
        strided convs run through ``fuse.conv2d_nhwc`` (cuDNN, TF32 off,
        one image at a time) and its 40 1x1 convs through K2 with one
        image's K split."""
        import dataclasses

        _cuda()
        from repro_torch.configs.pixellink_std import RESNET50
        from repro_torch.models.fcn import DetectionModel, build_head

        cfg = dataclasses.replace(RESNET50, image_size=(128, 128))
        if precision == "f32":
            cfg = dataclasses.replace(cfg, bfp=None, storage_fp16=False)
        model = DetectionModel(cfg, build_head("pixellink"), "cuda")
        params = model.init_params(torch.Generator().manual_seed(0))
        if precision == "bfp":
            params = model.normalize_weights(params)
        x = torch.rand((4, 128, 128, 3),
                       generator=torch.Generator().manual_seed(1)).cuda()
        batch = model.apply(params, x)
        for i in range(4):
            alone = model.apply(params, x[i:i + 1])
            for k in ("score", "links", "logits"):
                assert torch.equal(batch[k][i:i + 1], alone[k]), (i, k)
                assert bool(torch.isfinite(alone[k]).all())

    @pytest.mark.parametrize("model", ["east", "db"])
    def test_zoo_serving_on_card(self, model):
        """EAST and DB served on the card (width 0.125, bfp): sequential,
        pipelined and micro-batched boxes are equal, K1, K2 and K3 run
        17 / 7 / 0 (EAST) or 18 / 8 / 1 (DB) times a batch, and EAST's
        (score, geo) payload crosses to the host after the batch's event
        equal to the device tensors; DB's device box tail gives its host
        boxes."""
        _cuda()
        from repro_torch import kernels
        from repro_torch.data.images import RequestStream
        from repro_torch.launch.serve import STDService

        images = RequestStream(6, seed=3,
                               hw_range=((48, 64), (48, 128))).images()
        geo = dict(width=0.125, buckets=(64, 128), max_batch=4,
                   max_wait_ms=20, precision="bfp", model=model,
                   score_thr=0.47 if model == "east" else 0.5,
                   device="cuda")
        svc = STDService(**geo)
        single = [svc(img) for img in images]
        assert svc.serve_pipelined(images) == single
        kernels.reset_launch_counts()
        assert svc.serve_batched(images) == single
        n = len(svc.stats["batching"]["batches"])
        per = (17, 7, 0) if model == "east" else (18, 8, 1)
        counts = kernels.launch_counts()
        assert (counts["winograd_tiles"], counts["bfp_matmul_quantized"],
                counts["local_spread_converge"]) == tuple(p * n for p in per)
        x, valid, _ = svc.preprocess(images[0])
        pending, meta = svc._dispatch(x[None], [valid])
        assert isinstance(meta[4], torch.cuda.Event)
        payload = svc._finalize((pending, meta))[0]
        if model == "east":
            score, geo_map = payload
            assert np.array_equal(score, pending[0][0].cpu().numpy())
            assert np.array_equal(geo_map, pending[1][0].cpu().numpy())
        else:
            dev = STDService(**geo, postprocess="device",
                             params=svc.factory.params(
                                 (64, 64), "f32", "db"))
            assert [dev(img) for img in images] == single

    def test_wrappers_count_one_launch_and_check_inputs(self):
        dev = _cuda()
        from repro_torch import kernels

        x = torch.zeros((1, 8, 8, 3), device=dev)
        u = torch.zeros((36, 3, 5), device=dev)
        kernels.reset_launch_counts()
        winograd_tiles(x, u)
        assert kernels.launch_counts()["winograd_tiles"] == 1
        with pytest.raises(ValueError):       # f64 is not taken
            winograd_tiles(x.double(), u.double())
        with pytest.raises(ValueError):       # innermost stride 2
            winograd_tiles(torch.zeros((1, 8, 8, 6), device=dev)[..., ::2],
                           u)
        assert kernels.launch_counts()["winograd_tiles"] == 1
        q = torch.zeros((1, 2, 8, 16), device=dev)
        flash_attention(q, q[:, :1].contiguous(), q[:, :1].contiguous())
        with pytest.raises(ValueError):       # head dim above 128
            flash_attention(*(torch.zeros((1, 1, 8, 136), device=dev),) * 3)
        c = torch.zeros((1, 1, 8, 4), device=dev)
        xdt = torch.zeros((1, 1, 2, 8, 4), device=dev)
        scum = torch.zeros((1, 1, 2, 8, 1), device=dev)
        ssd_chunk(c, c, xdt, scum)
        with pytest.raises(ValueError):       # f64 is not taken
            ssd_chunk(c.double(), c.double(), xdt.double(), scum.double())
        with pytest.raises(ValueError):       # innermost stride 2
            ssd_chunk(c, c, torch.zeros((1, 1, 2, 8, 8), device=dev)[..., ::2],
                      scum)
        counts = kernels.launch_counts()
        assert counts["flash_attention_padded"] == 1
        assert counts["ssd_chunk"] == 1

    # -- execution plans: band-extended shapes and plans on one card ------
    @pytest.mark.parametrize("shape", [
        (2, 136, 512, 64, 64),     # conv1_2, one band of 4 of a 512 plane
        (2, 40, 64, 512, 512),     # conv5_1, one band of 4: 8 + 2 x 4 rows
        (1, 72, 128, 128, 128)])   # ResNet-50 s1, one band of 2 at 256
    def test_winograd_kernel_band_shapes(self, shape):
        """K1 at shapes only the row-banded plans give it (a band plus a
        4-row halo on each side), against its plain version on the card."""
        dev = _cuda()
        n, h, w, cin, cout = shape
        x = torch.from_numpy(_normal(h, (n, h, w, cin))).to(dev)
        k = torch.from_numpy(_normal(w, (3, 3, cin, cout))
                             * (2.0 / (9 * cin)) ** 0.5).to(dev)
        b = torch.from_numpy(_normal(cout, (cout,))).to(dev)
        got = winograd_conv2d(x, k, b, relu=True)
        u = wg.transform_weights(k).reshape(36, cin, cout)
        want = winograd_tiles_plain(x, u, b, padding="SAME", relu=True)
        torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)

    @pytest.mark.parametrize("shape,bands", [
        ((2, 128, 128, 128, 256), 4),  # full plane 16-warp blocks, bands 8
        ((2, 64, 64, 512, 512), 2),    # 8-warp blocks both
        ((1, 256, 128, 64, 64), 4),
        ((2, 8, 16, 512, 512), 4)])    # 2 rows a band: offsets off the tiles
    def test_winograd_band_rows_equal_full_plane(self, shape, bands):
        """K1 on each band extended by its 4-row halo out to plane rows at
        multiples of 4 (``runtime/collectives.halo_exchange``, ``align``
        4) gives the band's rows of the full-plane output bit for bit,
        whichever block shape each launch picks and wherever the band
        starts: every tile is the full plane's and its sum runs in the
        same order."""
        dev = _cuda()
        from repro_torch.runtime.collectives import halo_bounds, halo_exchange

        n, h, w, cin, cout = shape
        x = torch.from_numpy(_normal(h, (n, h, w, cin))).to(dev)
        k = torch.from_numpy(_normal(w, (3, 3, cin, cout))
                             * (2.0 / (9 * cin)) ** 0.5).to(dev)
        b = torch.from_numpy(_normal(cout, (cout,))).to(dev)
        full = winograd_conv2d(x, k, b, relu=True)
        bh = h // bands
        ext = halo_exchange(list(x.split(bh, dim=1)), 4, align=4)
        for i, (xb, (lo, _)) in enumerate(zip(ext, halo_bounds(bands, bh, 4,
                                                               4))):
            got = winograd_conv2d(xb.contiguous(), k, b, relu=True)
            j = i * bh - lo
            assert torch.equal(got[:, j:j + bh],
                               full[:, i * bh:(i + 1) * bh]), i

    @pytest.mark.parametrize("op", ["upsample_fused", "conv7x7s2",
                                    "conv3x3s2"])
    def test_glue_convs_on_band_planes(self, op, request):
        """The glue layers outside K1 and K2 (the fused upsample, whose tap
        products run as GEMMs of one fixed shape, and the strided convs,
        through cuDNN one image at a time) on a band extended by its
        halo, against the same rows of the full plane: within 1e-5
        relative, and the upsample bit-equal; whether the strided convs
        are bit-equal is recorded (``bit_equal`` in the junit
        properties), since cuDNN picks their algorithm from the shape."""
        dev = _cuda()
        from repro_torch.core import fuse
        from repro_torch.core.rowband import layer_halo
        from repro_torch.runtime.collectives import halo_exchange

        k, s, cin, cout, h = {"upsample_fused": (3, 1, 128, 64, 32),
                              "conv7x7s2": (7, 2, 3, 64, 512),
                              "conv3x3s2": (3, 2, 128, 128, 128)}[op]
        x = torch.from_numpy(_normal(h, (1, h, 2 * h, cin))).to(dev)
        w = torch.from_numpy(_normal(cin, (k, k, cin, cout))
                             * (2.0 / (k * k * cin)) ** 0.5).to(dev)
        if op == "upsample_fused":
            fn, scale = (lambda a: fuse.upsample2x_conv3x3_fused(a, w)), 2
        else:
            fn, scale = (lambda a: fuse.conv2d_nhwc(a, w, s, "SAME")), 1
        full = fn(x)
        halo, bh = layer_halo(k, s), h // 4
        equal = True
        for i, xb in enumerate(halo_exchange(list(x.split(bh, dim=1)),
                                             halo)):
            j0, rows = halo * scale // s, bh * scale // s
            got = fn(xb)[:, j0:j0 + rows]
            want = full[:, i * rows:(i + 1) * rows]
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            equal = equal and torch.equal(got, want)
        request.node.user_properties.append(("bit_equal", equal))
        assert equal or op != "upsample_fused"

    @pytest.mark.parametrize("rows,k,n", [(512 * 512 // 16, 640, 128),
                                          (64 * 64, 1024, 8)])
    def test_bfp_matmul_band_rows_equal_full_plane(self, rows, k, n):
        """K2 on one band's rows with the whole plane's K split
        (``split_rows``): each band's rows are bit-equal to the same rows
        of the full-plane product, and within 1e-4 of the plain version."""
        dev = _cuda()
        a = torch.relu(torch.from_numpy(_normal(k, (2 * rows, k)))).to(dev)
        bm = torch.from_numpy(_normal(n, (k, n)) * (2.0 / k) ** 0.5).to(dev)
        ops = quantize_operands(a, bm)
        full = bfp_matmul_quantized(*ops, split_rows=rows)
        for bands in (2, 4):
            step = rows // bands
            for i in range(2 * bands):
                ma, ea = ops[0][i * step:(i + 1) * step], \
                    ops[1][i * step:(i + 1) * step]
                got = bfp_matmul_quantized(ma, ea, ops[2], ops[3],
                                           split_rows=rows)
                assert torch.equal(got, full[i * step:(i + 1) * step])
        torch.testing.assert_close(
            full, bfp_matmul_quantized_plain(*ops, block_size=32,
                                             mantissa_bits=10),
            atol=1e-4, rtol=1e-4)

    @staticmethod
    def _plans_against_single_device(backbone, hw, plans, request):
        """Each ``(plan, bands, shards)`` of ``plans`` with every slot on
        cuda:0, full width in bfp at ``hw``, batch 2: maps within
        chip_smoke's map gate of SingleDevice's, labels equal, and one
        call's launches K1 17 / K2 7 (VGG-16) or 40 (ResNet-50) per band
        and shard, K3 once (per shard for DataParallel).  Each plan's
        largest map delta goes to the junit properties."""
        _cuda()
        import dataclasses

        from repro_torch import kernels
        from repro_torch.configs.pixellink_std import RESNET50, VGG16
        from repro_torch.models.fcn import DetectionModel, build_head
        from repro_torch.runtime.executor import (
            DataParallel, EngineFactory, SingleDevice)

        cfg = VGG16 if backbone == "vgg16" else RESNET50
        k2 = 7 if backbone == "vgg16" else 40
        fac = EngineFactory(
            lambda hw_, precision, model: DetectionModel(
                dataclasses.replace(cfg, image_size=hw_), build_head(model),
                "cuda"), device="cuda")
        params = fac.params(hw, "bfp")
        x = torch.from_numpy(np.random.default_rng(0).uniform(
            0, 1, (2,) + hw + (3,)).astype(np.float32)).cuda()
        vq = torch.tensor([[hw[0] // 4, hw[1] // 4],
                           [hw[0] // 4 - 28, 60]], dtype=torch.int32,
                          device="cuda")
        single = fac.plan_fn(hw, 2, SingleDevice(), "bfp")
        want = single.forward(params, x)
        want_labels = single(params, x, vq)[0]
        scale = (float(want["logits"].abs().max()) if backbone == "resnet50"
                 else None)
        gate = (2.5e-3 * scale, 2.5e-4 * scale) if scale else (2e-2, 2e-3)
        for plan, bands, shards in plans:
            fn = fac.plan_fn(hw, 2, plan, "bfp")
            kernels.reset_launch_counts()
            labels, converged = fn(params, x, vq)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            assert counts["winograd_tiles"] == 17 * bands * shards
            assert counts["bfp_matmul_quantized"] == k2 * bands * shards
            assert counts["local_spread_converge"] == (
                shards if isinstance(plan, DataParallel) else 1)
            assert bool(converged.all())
            got = fn.forward(params, x)
            request.node.user_properties.append((repr(plan)[:12] + str(
                (bands, shards)), max(float((got[k] - want[k]).abs().max())
                                      for k in ("score", "links"))))
            for name in ("score", "links"):
                d = (got[name] - want[name]).abs()
                assert float(d.max()) <= gate[0], (plan, name)
                assert float(d.mean()) <= gate[1], (plan, name)
            assert torch.equal(labels, want_labels), plan

    @staticmethod
    def _card_mesh(shape):
        from repro_torch.launch.mesh import make_host_mesh

        return make_host_mesh(shape, ("data", "model"), device="cuda:0")

    @pytest.mark.parametrize("backbone", ["vgg16", "resnet50"])
    def test_plans_match_single_device_on_card(self, backbone, request):
        """RowBand (2, 4), DataParallel (2) and GridPlan (2x2) at 512x256
        (:meth:`_plans_against_single_device`): 512 rows keep every band
        offset a multiple of 4 rows down to stride 32."""
        _cuda()
        from repro_torch.runtime.executor import (DataParallel, GridPlan,
                                                  RowBand)

        mesh = self._card_mesh
        self._plans_against_single_device(
            backbone, (512, 256),
            ((RowBand(mesh((1, 2))), 2, 1), (RowBand(mesh((1, 4))), 4, 1),
             (DataParallel(mesh((2, 1))), 1, 2),
             (GridPlan(mesh((2, 2))), 2, 2)), request)

    @pytest.mark.parametrize("backbone", ["vgg16", "resnet50"])
    def test_unaligned_bands_match_single_device_on_card(self, backbone,
                                                         request):
        """RowBand(4) of a 256-row plane leaves two rows a band at stride
        32, so band offsets there are not multiples of K1's 4-row tile;
        the exchange's tile alignment keeps the tiles the full plane's,
        and the plan is held as the aligned ones are
        (:meth:`_plans_against_single_device`)."""
        _cuda()
        from repro_torch.runtime.executor import RowBand

        self._plans_against_single_device(
            backbone, (256, 256), ((RowBand(self._card_mesh((1, 4))), 4, 1),),
            request)

    # -- training on the card -------------------------------------------------

    def test_training_step_on_card(self):
        """One train_std step on cuda:0 (VGG-16 PixelLink, width 0.25,
        64x64, batch 4, reference mode): finite loss, finite gradients
        for every leaf, zeros for the BN leaves the forward never reads,
        and params that moved."""
        dev = _cuda()
        from repro_torch.data.images import SyntheticSTDData
        from repro_torch.launch import train_std
        from repro_torch.models.fcn import PixelLinkModel, STDLoss
        from repro_torch.optim import adamw, value_and_grad

        model = PixelLinkModel(train_std.make_config(), dev)
        params = model.init_params(torch.Generator().manual_seed(0))
        batch = train_std.batch_on(
            SyntheticSTDData((64, 64), max_instances=3).sample(0, 4), dev)
        loss_fn = STDLoss()
        loss, grads = value_and_grad(
            lambda p: loss_fn(model.apply(p, batch["images"]),
                              batch["score"], batch["links"])["loss"],
            params)
        assert bool(torch.isfinite(loss))
        for name, leaves in grads.items():
            for k, g in leaves.items():
                assert g.device.type == "cuda" and bool(
                    torch.isfinite(g).all()), (name, k)
                if k in ("gamma", "beta", "mean", "var"):
                    assert not bool(g.any()), (name, k)
        init, update = adamw(3e-3, weight_decay=1e-4)
        step = train_std.make_train_step(model, loss_fn, update)
        (new, opt), d = step((params, init(params)), batch)
        assert float(d["loss"]) == pytest.approx(float(loss), rel=1e-5)
        assert int(opt.step) == 1
        assert not torch.equal(new["conv1_1"]["w"], params["conv1_1"]["w"])

    def test_serving_outputs_carry_no_graph(self):
        """Parameters that require grad, served on the card: the service's
        boxes come out, and the maps of SingleDevice and of a RowBand(2)
        plan carry no graph."""
        dev = _cuda()
        from repro_torch.launch.serve import STDService
        from repro_torch.runtime.executor import RowBand

        svc = STDService(width=0.125, buckets=(64,), device=dev)
        live = {n: {k: v.clone().requires_grad_(True) for k, v in p.items()}
                for n, p in svc.factory.params((64, 64)).items()}
        svc.factory.set_params(live)
        img = np.random.default_rng(0).uniform(0, 1, (60, 52, 3)) \
            .astype(np.float32)
        assert isinstance(svc(img), list)
        x = torch.rand(1, 64, 64, 3, device=dev)
        vq = torch.full((1, 2), 16, dtype=torch.int32, device=dev)
        for plan in (None, RowBand(self._card_mesh((1, 2)))):
            fn = svc.factory.plan_fn((64, 64), 1, plan)
            maps = fn.forward(live, x)
            labels, converged = fn(live, x, vq)
            assert not any(t.requires_grad for t in maps.values()), plan
            assert not labels.requires_grad and bool(converged.all())

    def test_checkpoint_from_card_restores_on_cpu(self):
        """A params + AdamW (bfp8 moments) tree saved from cuda:0 restores
        onto the CPU bit for bit, and back onto the card."""
        import tempfile

        dev = _cuda()
        from repro_torch.checkpoint import (restore_checkpoint,
                                            save_checkpoint)
        from repro_torch.core import tree as tree_lib
        from repro_torch.optim import adamw

        params = {"a": torch.arange(12.0, device=dev).reshape(3, 4)
                  .to(torch.bfloat16),
                  "b": {"c": torch.from_numpy(_normal(0, (5, 40))).to(dev)}}
        init, update = adamw(1e-2, moment_dtype="bfp8")
        st = init(params)
        g = tree_lib.tree_map(lambda p: torch.ones(p.shape, device=dev),
                              params)
        params, st = update(g, st, params)
        tree = {"params": params, "opt": st}
        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(d, 1, tree, blocking=False).join()
            cpu = restore_checkpoint(d, 1, tree, device="cpu")
            back = restore_checkpoint(d, 1, tree)
        for want, got, card in zip(tree_lib.leaves(tree),
                                   tree_lib.leaves(cpu),
                                   tree_lib.leaves(back)):
            assert got.device.type == "cpu" and card.device == want.device
            assert got.dtype == want.dtype
            assert torch.equal(got.view(torch.int16) if got.dtype ==
                               torch.bfloat16 else got,
                               (want.view(torch.int16) if want.dtype ==
                                torch.bfloat16 else want).cpu())
            assert torch.equal(card, want)

    # -- the moe, audio and vlm LM families on the card -----------------------

    @pytest.mark.parametrize("arch", ["grok-1-314b", "kimi-k2-1t-a32b",
                                      "whisper-tiny", "internvl2-76b"])
    def test_lm_family_on_card(self, arch):
        """A smoke config's prefill on cuda:0 (f32, seeded weights drawn
        on the CPU): one K4 launch per decoder layer and none of the
        other kernels (Whisper's encoder runs dense), logits within 1e-2
        of the CPU's; decode steps launch nothing and agree with the
        CPU's on the same tokens within 1e-2."""
        dev = _cuda()
        from repro_torch import kernels
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch import serve_lm
        from repro_torch.models.lm import LMModel

        def to(tree, where):
            if isinstance(tree, dict):
                return {k: to(v, where) for k, v in tree.items()}
            return tree.to(where)

        cfg = get_smoke_config(arch)
        cpu_model, model = LMModel(cfg, "cpu"), LMModel(cfg, dev)
        params = cpu_model.init_params(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(3)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 20)))
        prefix = serve_lm.prefix_embed_for(cfg, 2,
                                           torch.Generator().manual_seed(9))
        kw = {} if prefix is None else {"prefix_embed": prefix}
        start = serve_lm.decode_start(cfg, 16)
        _, want, cpu_cache = serve_lm.prefill(cpu_model, params, toks[:, :16],
                                              start + 4, **kw)
        kernels.reset_launch_counts()
        _, got, cache = serve_lm.prefill(model, to(params, dev),
                                         toks[:, :16].to(dev), start + 4,
                                         **to(kw, dev))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts.pop("flash_attention_padded") == cfg.n_layers
        assert not any(counts.values()), counts
        torch.testing.assert_close(got.cpu(), want, atol=1e-2, rtol=1e-2)
        kernels.reset_launch_counts()
        for t in range(16, 20):
            want, cpu_cache = cpu_model.decode_step(
                params, toks[:, t:t + 1], cpu_cache, start + t - 16)
            got, cache = model.decode_step(
                to(params, dev), toks[:, t:t + 1].to(dev), cache,
                start + t - 16)
            torch.testing.assert_close(got.cpu(), want, atol=1e-2, rtol=1e-2)
        assert not any(kernels.launch_counts().values())

    @pytest.mark.parametrize("n_experts,top_k,fission,cf", [
        (384, 8, 1, 1.25), (8, 2, 2, 0.5), (8, 2, 1, 16.0)])
    def test_moe_routing_on_card_equals_cpu(self, n_experts, top_k, fission,
                                            cf):
        """The same f32 router logits routed on the card and on the CPU:
        expert ids, ranks and keep masks equal."""
        dev = _cuda()
        from repro_torch.models.lm import moe

        table = {"n_experts": n_experts, "top_k": top_k, "fission": fission,
                 "capacity_factor": cf}
        gates = torch.from_numpy(_normal(7, (64, n_experts)) * 3)
        want = moe.route(gates, table)
        got = moe.route(gates.to(dev), table)
        assert (got.cap, got.n_experts) == (want.cap, want.n_experts)
        for name in ("topi", "pos", "keep"):
            assert torch.equal(getattr(got, name).cpu(),
                               getattr(want, name)), name
        torch.testing.assert_close(got.topv.cpu(), want.topv, atol=1e-6,
                                   rtol=1e-5)

    def test_expert_bmm_bf16_f32_result(self):
        """bf16 expert products on the card (cuBLAS with an f32 result)
        against the widened f32 product (TF32 off) within 1e-3."""
        dev = _cuda()
        from repro_torch.core import resolve_device
        from repro_torch.models.lm import moe

        resolve_device(dev)
        a = torch.from_numpy(_normal(8, (8, 40, 256))).to(dev).bfloat16()
        w = torch.from_numpy(_normal(9, (8, 256, 96)) / 16).to(dev) \
            .bfloat16()
        got = moe._expert_matmul(a, w, torch.bfloat16)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, torch.bmm(a.float(), w.float()),
                                   atol=1e-3, rtol=1e-3)

    @pytest.mark.parametrize("a_shape,w_shape", [((96, 256), (256, 80)),
                                                 ((4, 40, 256), (4, 256, 96))])
    def test_low_precision_matmul_backward(self, a_shape, w_shape):
        """low_precision_matmul's (grad_a, grad_w) against autograd of the
        widened f32 product (TF32 off).  Its backward rounds the f32
        cotangent to bf16 (at most 2^-9 of each element) and returns bf16
        (2^-9 again), so each gradient element lies within (2^-8 + 2^-12)
        of the sum of its terms' magnitudes (|g| @ |w|ᵀ, |a|ᵀ @ |g|) of
        the f32 one; 2^-12 covers the f32 accumulation over K = 256."""
        dev = _cuda()
        from repro_torch.models.lm.layers import low_precision_matmul

        a = torch.from_numpy(_normal(10, a_shape)).to(dev).bfloat16() \
            .requires_grad_()
        w = (torch.from_numpy(_normal(11, w_shape)) / 16).to(dev) \
            .bfloat16().requires_grad_()
        g = torch.from_numpy(_normal(12, a_shape[:-1] + w_shape[-1:])) \
            .to(dev)
        y = low_precision_matmul(a, w)
        assert y.dtype == torch.float32
        ga, gw = torch.autograd.grad(y, (a, w), g)
        assert ga.dtype == gw.dtype == torch.bfloat16
        a32, w32 = (t.detach().float().requires_grad_() for t in (a, w))
        want_a, want_w = torch.autograd.grad(torch.matmul(a32, w32),
                                             (a32, w32), g)
        tol = 2.0 ** -8 + 2.0 ** -12
        bound_a = tol * (g.abs() @ w32.detach().abs().transpose(-1, -2))
        bound_w = tol * (a32.detach().abs().transpose(-1, -2) @ g.abs())
        assert bool(((ga.float() - want_a).abs() <= bound_a).all())
        assert bool(((gw.float() - want_w).abs() <= bound_w).all())

    # -- LM training on the card ----------------------------------------------

    def test_k4_k5_refuse_autograd_on_card(self):
        """K4 and K5 have no backward: on the card, as on the CPU, an
        operand that requires grad makes the wrapper raise, and a
        train-mode forward through their routes raises with them; under
        no_grad the same calls launch."""
        dev = _cuda()
        from repro_torch import configs
        from repro_torch.core import tree as tree_lib
        from repro_torch.models.lm import LMModel

        q, k, v = (torch.from_numpy(_normal(i, (1, 2, 64, 64))).to(dev)
                   .requires_grad_(True) for i in range(3))
        c, b = (torch.from_numpy(_normal(i, (2, 1, 16, 8))).to(dev)
                .requires_grad_(True) for i in (3, 4))
        xdt = torch.from_numpy(_normal(5, (2, 1, 2, 16, 8))).to(dev)
        scum = -torch.cumsum(torch.from_numpy(
            np.abs(_normal(6, (2, 1, 2, 16, 1)))).to(dev), dim=3)
        calls = [(flash_attention_padded,
                  lambda: flash_attention_padded(q, k, v, sm_scale=0.125,
                                                 causal=True, kv_len=64)),
                 (ssd_chunk, lambda: ssd_chunk(c, b, xdt, scum))]
        for wrapper, call in calls:
            with pytest.raises(RuntimeError, match="no backward"):
                call()
            before = wrapper.launches
            with torch.no_grad():
                call()
            assert wrapper.launches == before + 1
        for arch in ("tinyllama-1.1b", "mamba2-370m"):
            model = LMModel(configs.get_smoke_config(arch), dev)
            live = tree_lib.tree_map(
                lambda p: p.requires_grad_(True),
                model.init_params(torch.Generator(dev).manual_seed(0)))
            toks = torch.randint(0, model.cfg.vocab, (2, 16), device=dev)
            ctx = {"use_flash": True, "use_kernel": True}
            with pytest.raises(RuntimeError, match="no backward"):
                model.forward(live, toks, ctx_extra=ctx)
            with torch.no_grad():
                assert model.forward(live, toks, ctx_extra=ctx).grad_fn \
                    is None

    @pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
    def test_lm_train_step_on_card(self, param_dtype):
        """A mode="train" TinyLlama smoke step on the card (remat on): the
        logits keep their grad_fn on the plain routes, every gradient is
        finite and on the card, in the leaf's type, and the step matches
        the same step on the CPU (f32: loss 1e-5 relative, gradients 1e-3
        of each leaf's largest |g|; bf16: 2^-8 and 2^-5, a few units of
        bf16's rounding, which the card's backward applies to each f32
        cotangent and either device to each bf16 activation)."""
        import dataclasses

        dev = _cuda()
        from repro_torch import configs
        from repro_torch.core import tree as tree_lib
        from repro_torch.models.lm import LMModel, cross_entropy
        from repro_torch.optim import value_and_grad

        cfg = dataclasses.replace(configs.get_smoke_config("tinyllama-1.1b"),
                                  param_dtype=param_dtype,
                                  compute_dtype=param_dtype, remat=True)
        cpu = LMModel(cfg, "cpu")
        params = cpu.init_params(torch.Generator().manual_seed(0))
        toks = torch.randint(0, cfg.vocab, (2, 16),
                             generator=torch.Generator().manual_seed(1))
        out = {}
        for model, d in ((LMModel(cfg, dev), dev), (cpu, "cpu")):
            p = tree_lib.tree_map(lambda t: t.to(d), params)
            live = tree_lib.tree_map(lambda t: t.requires_grad_(True), p)
            assert model.forward(live, toks.to(d)).grad_fn is not None
            out[str(d)] = value_and_grad(
                lambda q: cross_entropy(model.forward(q, toks.to(d)),
                                        toks.to(d)), p)
        (loss, grads), (want_loss, want) = out[str(dev)], out["cpu"]
        assert bool(torch.isfinite(loss))
        for g, w in zip(tree_lib.leaves(grads), tree_lib.leaves(want)):
            assert g.device.type == "cuda" and g.dtype == w.dtype
            assert bool(torch.isfinite(g).all())
        loss_rel, grad_share = (1e-5, 1e-3) if param_dtype == "float32" \
            else (2.0 ** -8, 2.0 ** -5)
        assert float(loss) == pytest.approx(float(want_loss), rel=loss_rel)
        for g, w in zip(tree_lib.leaves(grads), tree_lib.leaves(want)):
            err = float((g.cpu().float() - w.float()).abs().max())
            assert err <= grad_share * float(w.float().abs().max())

    def test_prefetcher_puts_token_batches_on_card(self):
        """Prefetcher(device="cuda") yields TokenDataset's batches on the
        card, each read on the consumer's stream after its copy."""
        dev = _cuda()
        from repro_torch.data import Prefetcher, TokenDataset

        ds = TokenDataset(1000, 128, 8, seed=0)
        got = list(Prefetcher((ds.batch(i) for i in range(6)), device=dev))
        assert len(got) == 6
        for i, b in enumerate(got):
            want = ds.batch(i)
            for k in ("tokens", "labels"):
                assert b[k].device.type == "cuda"
                # a read on the consumer's stream, before any sync
                assert int((b[k].long().sum()).item()) == int(want[k].sum())
                np.testing.assert_array_equal(b[k].cpu().numpy(), want[k])

    @pytest.mark.parametrize("S,remat", [(4, True), (2, False)])
    def test_pipeline_on_card_equals_cpu(self, S, remat):
        """pipeline_apply of an InternLM2 smoke stack (8 layers, f32) on a
        (S, 2) host mesh of cuda:0 slots against the same call on "cpu"
        slots: forward within 1e-5 and the gradients of sum(y^2) w.r.t.
        the staged params and x within 1e-4 of each largest value."""
        import dataclasses

        dev = _cuda()
        from repro_torch import configs
        from repro_torch.core import tree as tree_lib
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.lm import LMModel
        from repro_torch.runtime.pipeline import (microbatch, pipeline_apply,
                                                  split_stages)

        cfg = dataclasses.replace(configs.get_smoke_config("internlm2-1.8b"),
                                  n_layers=8)
        layers = LMModel(cfg, "cpu").init_params(
            torch.Generator().manual_seed(0))["layers"]
        x = torch.from_numpy(_normal(3, (8, 16, cfg.d_model)))
        out = {}
        for d in (dev, "cpu"):
            staged = tree_lib.tree_map(
                lambda a: a.to(d).requires_grad_(True),
                split_stages(layers, S))
            xd = microbatch(x.to(d), 4).requires_grad_(True)
            mesh = make_host_mesh((S, 2), ("stage", "mdl"), device=d)
            y = pipeline_apply(mesh, "stage", LMModel(cfg, d).layer_fn(),
                               staged, xd, remat=remat)
            assert y.device.type == torch.device(d).type
            g = torch.autograd.grad((y ** 2).sum(),
                                    tree_lib.leaves(staged) + [xd])
            out[str(d)] = [y] + list(g)
        for i, (a, b) in enumerate(zip(out[str(dev)], out["cpu"],
                                       strict=True)):
            tol = (1e-5 if i == 0 else 1e-4) * float(b.detach().abs().max())
            assert float((a.detach().cpu() - b.detach()).abs().max()) <= tol

    def test_dryrun_argument_bytes_equal_placed_state(self, tmp_path):
        """The dry run's argument bytes of a TinyLlama smoke train cell on
        a 1x1 mesh equal the nbytes of the params, AdamW state and batch
        that build_train_step's arguments place on the card."""
        dev = _cuda()
        from repro_torch import configs
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.core import tree as tree_lib
        from repro_torch.launch import dryrun, step_fns
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.lm import LMModel
        from repro_torch.optim import adamw

        cfg = configs.get_smoke_config("tinyllama-1.1b")
        shape = ShapeConfig("t", 32, 4, "train")
        rec = dryrun.run_cell("tinyllama-1.1b", shape, smoke=True,
                              report_dir=str(tmp_path), verbose=False)
        assert rec["status"] == "ok", rec.get("traceback")
        mesh = make_host_mesh((1, 1), ("data", "model"), device=dev)
        built = step_fns.build_train_step(cfg, mesh, shape)
        params = LMModel(cfg, dev).init_params(
            torch.Generator(device=dev).manual_seed(0))
        opt = adamw(1e-3, moment_dtype=built.meta["moment_dtype"])[0](params)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                 for k, v in built.abstract_args[2].items()}
        placed = tree_lib.leaves((params, opt, batch))
        assert all(t.device.type == "cuda" for t in placed)
        assert rec["memory"]["argument_size_bytes"] == sum(
            t.numel() * t.element_size() for t in placed)
