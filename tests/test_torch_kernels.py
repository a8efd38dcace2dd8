"""The three kernel modules of repro_torch against the JAX reference.

On the CPU each wrapper runs its plain torch version, which is held
against the reference's Pallas kernel in interpret mode at the
reference's own tolerances: K2 ``bfp_matmul`` at atol 1e-4, K1
``winograd_conv2d`` at atol 2e-3, K3 ``cc_label`` exactly (labels,
round counts and convergence flags).  tests/test_torch_cuda.py holds
the CUDA kernels against these plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bfp_matmul import bfp_matmul as j_bfp_matmul
from repro.kernels.cc_label import cc_label_pallas
from repro.kernels.cc_label.kernel import local_spread_converge as j_local
from repro.kernels.winograd_conv import winograd_conv2d as j_winograd
from repro.models.fcn import postprocess as jpp
from repro_torch import kernels
from repro_torch.kernels.bfp_matmul import (
    bfp_matmul, bfp_matmul_quantized, bfp_matmul_quantized_plain,
    quantize_operands)
from repro_torch.kernels.bfp_matmul import ops as k2_ops
from repro_torch.kernels.cc_label import (
    cc_label_tiled, local_spread_converge, local_spread_converge_plain,
    local_spread_jacobi)
from repro_torch.data import cc_cases
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.core import winograd as wg
from repro_torch.kernels.winograd_conv import (
    winograd_conv2d, winograd_tiles, winograd_tiles_plain)
from repro_torch.models.fcn import postprocess as pp

torch.set_num_threads(2)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


class TestBFPMatmul:
    @pytest.mark.parametrize("mkn", [(8, 64, 8), (48, 100, 36),
                                     (128, 256, 128), (17, 33, 9),
                                     (40, 528, 16)])
    @pytest.mark.parametrize("mantissa_bits", [7, 10])
    def test_plain_matches_reference(self, mkn, mantissa_bits):
        M, K, N = mkn
        a, b = _normal(M + K, (M, K)), _normal(N + K, (K, N))
        got = bfp_matmul(torch.from_numpy(a), torch.from_numpy(b),
                         mantissa_bits=mantissa_bits).numpy()
        want = np.asarray(j_bfp_matmul(jnp.asarray(a), jnp.asarray(b),
                                       mantissa_bits=mantissa_bits,
                                       interpret=True))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

    def test_concat_k_straddles_blocks(self):
        """merge*_c1 reads a concat (16 + 512 = 528 channels): the 32-wide
        BFP block that straddles the two sources is quantized as one."""
        rng = np.random.default_rng(1)
        up = rng.standard_normal((64, 16)).astype(np.float32) * 100.0
        lat = rng.standard_normal((64, 512)).astype(np.float32) * 0.01
        a = np.concatenate([up, lat], axis=1)
        b = _normal(2, (528, 16))
        ma, ea, _, _ = quantize_operands(torch.from_numpy(a),
                                         torch.from_numpy(b))
        assert tuple(ea.shape) == (64, 17)       # 528 = 16 * 32 + 16
        got = bfp_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        want = np.asarray(j_bfp_matmul(jnp.asarray(a), jnp.asarray(b),
                                       interpret=True))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

    def test_cpu_runs_plain_and_counts_no_launch(self):
        kernels.reset_launch_counts()
        ops = quantize_operands(torch.from_numpy(_normal(0, (9, 40))),
                                torch.from_numpy(_normal(1, (40, 5))))
        got = bfp_matmul_quantized(*ops)
        want = bfp_matmul_quantized_plain(*ops, block_size=32,
                                          mantissa_bits=10)
        assert torch.equal(got, want)
        assert kernels.launch_counts()["bfp_matmul_quantized"] == 0


def _operand(kind, seed, shape):
    """Inputs that stress the BFP encoding: plain normals, zeros with
    all-zero blocks, subnormals (alone in a block and beside normals),
    and magnitudes spread over 2^-100 .. 2^100."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "zeros":
        x[rng.uniform(size=shape) < 0.3] = 0.0
        x[..., :32] = 0.0
    elif kind == "subnormal":
        x[..., :32] = 1e-40
        x[..., 32:40] = -3e-39
    elif kind == "wide":
        x = x * np.exp2(rng.integers(-100, 100, shape)).astype(np.float32)
    return x


class TestTensorCorePremises:
    """What the TF32 tensor-core design of K2 rests on, checked here in
    plain Python: dequantized operands are exact in TF32, and the tile
    chooser fills the card and keeps narrow outputs narrow."""

    @pytest.mark.parametrize("kind", ["normal", "zeros", "subnormal", "wide"])
    @pytest.mark.parametrize("rounding", ["trunc", "nearest"])
    @pytest.mark.parametrize("mantissa_bits", [3, 7, 10])
    def test_dequantized_operands_exact_in_tf32(self, kind, rounding,
                                                mantissa_bits):
        """Clearing the low 13 f32 mantissa bits (what TF32 drops) changes
        no dequantized operand."""
        a = _operand(kind, mantissa_bits, (24, 100))
        b = np.ascontiguousarray(_operand(kind, mantissa_bits + 1, (12, 100)).T)
        for block_size in (16, 32):
            ma, ea, mb, eb = quantize_operands(
                torch.from_numpy(a), torch.from_numpy(b),
                block_size=block_size, mantissa_bits=mantissa_bits,
                rounding=rounding)
            assert int(ma.abs().max()) <= 2 ** mantissa_bits
            assert int(mb.abs().max()) <= 2 ** mantissa_bits
            for m, e in ((ma, ea), (mb.t(), eb)):
                x = k2_ops._dequantize(m, e, block_size, mantissa_bits)
                bits = x.view(torch.int32)
                assert torch.equal(bits & ~0x1FFF, bits)

    def test_k2_shapes_of_the_program(self):
        """The seven 1x1 convs of VGG-16 PixelLink at 512x512, batch 2,
        as the engine's program lists them for K2."""
        import dataclasses

        from repro_torch.configs.pixellink_std import VGG16
        from repro_torch.models.fcn import DetectionModel, build_head

        engine = DetectionModel(dataclasses.replace(VGG16,
                                                    image_size=(512, 512)),
                                build_head("pixellink"), "cpu").engine
        assert engine.k2_shapes(2) == [
            ("merge1_sq", 512, 512, 128), ("merge1_c1", 2048, 640, 128),
            ("merge2_sq", 2048, 128, 64), ("merge2_c1", 8192, 320, 64),
            ("merge3_sq", 8192, 64, 32), ("merge3_c1", 32768, 160, 32),
            ("head_logits", 32768, 32, 9)]

    @pytest.mark.parametrize("M,K,N", [
        (512, 512, 128), (2048, 640, 128), (2048, 128, 64), (8192, 320, 64),
        (8192, 64, 32), (32768, 160, 32), (32768, 32, 9), (17, 33, 9),
        (100, 8, 300), (1000, 96, 16)])
    def test_launch_shape(self, M, K, N):
        """Few masked columns, a full card where K allows, and splits of
        at least one K step each."""
        tm, tn, splits = k2_ops.launch_shape(M, N, K)
        assert (tm, tn) in ((64, 64), (64, 32), (128, 16))
        assert tn == 16 if N <= 16 else tn <= -(-N // 32) * 32
        assert splits in (1, 2, 4, 8) and splits <= -(-K // k2_ops.TK)
        blocks = -(-M // tm) * -(-N // tn) * splits
        if (M, K, N) == (2048, 640, 128):          # merge1_c1
            assert blocks >= 132
        if blocks < k2_ops.MIN_BLOCKS and splits < 8:
            assert 2 * splits > -(-K // k2_ops.TK)
        assert k2_ops.smem_bytes(tm, tn, -(-K // 16)) <= k2_ops.SMEM_MAX

    @pytest.mark.parametrize("rows,K,N", [
        (1024, 640, 128), (256, 512, 128), (4096, 320, 64), (64, 640, 128),
        (16384, 32, 9)])
    def test_launch_shape_batch_invariant(self, rows, K, N):
        """With ``split_rows`` one image's rows, the tile and the K split,
        and so every output's sum order, are the same at every batch."""
        got = {k2_ops.launch_shape(b * rows, N, K, split_rows=rows)
               for b in (1, 2, 3, 4, 8)}
        assert got == {k2_ops.launch_shape(rows, N, K)}


class TestWinograd:
    @pytest.mark.parametrize("hwcc,padding", [
        ((5, 7, 3, 5), "SAME"), ((19, 23, 6, 10), "SAME"),
        ((12, 4, 1, 1), "SAME"), ((6, 9, 3, 5), "VALID"),
        ((13, 5, 4, 4), "VALID"), ((6, 6, 2, 3), "SAME")])
    def test_plain_matches_reference(self, hwcc, padding):
        h, w, cin, cout = hwcc
        x, k = _normal(h, (2, h, w, cin)), _normal(w, (3, 3, cin, cout))
        got = winograd_conv2d(torch.from_numpy(x), torch.from_numpy(k),
                              padding=padding).numpy()
        want = np.asarray(j_winograd(jnp.asarray(x), jnp.asarray(k),
                                     padding=padding, interpret=True))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)

    @pytest.mark.parametrize("relu", [False, True])
    def test_fused_bias_relu(self, relu):
        x, k, b = (_normal(3, (2, 10, 7, 5)), _normal(4, (3, 3, 5, 6)),
                   _normal(5, (6,)))
        got = winograd_conv2d(torch.from_numpy(x), torch.from_numpy(k),
                              torch.from_numpy(b), relu=relu).numpy()
        want = np.asarray(j_winograd(jnp.asarray(x), jnp.asarray(k),
                                     jnp.asarray(b), relu=relu,
                                     interpret=True))
        np.testing.assert_allclose(got, want, atol=2e-3)
        if relu:
            assert got.min() >= 0.0


    @pytest.mark.parametrize("hwcc,padding", [
        ((9, 14, 3, 7), "SAME"), ((9, 14, 3, 7), "VALID"),
        ((17, 6, 8, 5), "SAME"), ((11, 13, 12, 16), "VALID")])
    def test_kernel_plain_matches_reference(self, hwcc, padding):
        """The kernel's plain version (input plane and U in, cropped
        NHWC plane out, bias and ReLU fused) against the reference's
        Pallas kernel: Cin 3, H and W not multiples of 4, both paddings."""
        h, w, cin, cout = hwcc
        x, k = _normal(h + w, (2, h, w, cin)), _normal(cin, (3, 3, cin, cout))
        b = _normal(cout, (cout,))
        u = wg.transform_weights(torch.from_numpy(k)).reshape(36, cin, cout)
        got = winograd_tiles_plain(torch.from_numpy(x), u,
                                   torch.from_numpy(b), padding=padding,
                                   relu=True).numpy()
        want = np.asarray(j_winograd(jnp.asarray(x), jnp.asarray(k),
                                     jnp.asarray(b), padding=padding,
                                     relu=True, interpret=True))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)

    def test_k1_shapes_of_the_program(self):
        """The 17 stride-1 3x3 convs of VGG-16 PixelLink at 512x512,
        batch 2, as the engine's program lists them for K1: 13 in the
        trunk, 4 in the merge."""
        import dataclasses

        from repro_torch.configs.pixellink_std import VGG16
        from repro_torch.models.fcn import DetectionModel, build_head

        engine = DetectionModel(dataclasses.replace(VGG16,
                                                    image_size=(512, 512)),
                                build_head("pixellink"), "cpu").engine
        shapes = engine.k1_shapes(2)
        assert len(shapes) == 17
        assert shapes[:2] == [("conv1_1", 2, 512, 512, 3, 64),
                              ("conv1_2", 2, 512, 512, 64, 64)]
        assert ("conv5_1", 2, 32, 32, 512, 512) in shapes
        assert [s[0] for s in shapes[13:]] == [
            "merge1_c3", "merge2_c3", "merge3_c3", "fuse_out"]
        assert len({s[2:] for s in shapes}) == 12


def _trunc(x):
    """f32 as the tensor cores read a TF32 operand: the 13 low bits
    dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x):
    """The kernels' split (tf32x3::split): hi truncated, lo = x - hi as
    the tensor cores read it."""
    hi = _trunc(x)
    return hi, _trunc(x - hi)


class TestTF32Premise:
    """What K1's and K4 f32's tensor-core designs rest on, emulated in
    torch: a hi + lo pair of TF32 terms carries an f32 operand, three
    products of the pairs meet the kernel's tolerance, and one TF32 term
    does not."""

    def test_hi_lo_carries_f32(self):
        rng = np.random.default_rng(0)
        x = torch.from_numpy((rng.standard_normal(100_000) * np.exp2(
            rng.integers(-60, 60, 100_000))).astype(np.float32))
        hi, lo = _split(x)
        assert torch.equal(hi.view(torch.int32) & 0x1FFF,
                           torch.zeros_like(x, dtype=torch.int32))
        err = ((hi.double() + lo.double()) - x.double()).abs()
        assert bool((err <= 2.0 ** -21 * x.double().abs()).all())

    @pytest.mark.parametrize("hw,cin,cout", [(64, 64, 64), (16, 512, 512),
                                             (64, 3, 64)])
    def test_three_products_meet_k1_tolerance(self, hw, cin, cout):
        """conv1_2-, conv5_1- and conv1_1-like layers: the kernel's V (f32
        transform) and U split into hi + lo, products summed exactly, held
        against the convolution in f64 at atol/rtol 2e-3."""
        rng = np.random.default_rng(cin)
        x = torch.from_numpy(rng.standard_normal((1, hw, hw, cin))
                             .astype(np.float32))
        w = torch.from_numpy((rng.standard_normal((3, 3, cin, cout))
                              * (2.0 / (9 * cin)) ** 0.5).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
        u = wg.transform_weights(w).reshape(36, cin, cout)
        want = torch.nn.functional.conv2d(
            x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
            b.double(), padding=1).permute(0, 2, 3, 1)
        v, (oh, ow, th, tw) = wg.input_tiles(x)
        (vh, vl), (uh, ul) = _split(v), _split(u)

        def emulated(pairs):
            m = sum(torch.bmm(a.double().transpose(0, 1), c.double())
                    for a, c in pairs).float()
            y = wg.transform_output(m.reshape(6, 6, -1, cout)
                                    .permute(2, 3, 0, 1)).permute(2, 3, 0, 1)
            return wg.tiles_to_nhwc(y + b, 1, th, tw, oh, ow).double()

        three = emulated([(vh, ul), (vl, uh), (vh, uh)])
        torch.testing.assert_close(three, want, atol=2e-3, rtol=2e-3)
        one = emulated([(vh, uh)])
        assert not torch.allclose(one, want, atol=2e-3, rtol=2e-3)

    @pytest.mark.parametrize("qk_scale,v_scale,one_misses", [
        (1.0, 1.0, False), (2.0, 32.0, True)])
    def test_three_products_meet_k4_f32_tolerance(self, qk_scale, v_scale,
                                                  one_misses):
        """K4's f32 kernel on a small head (L 128, D 80, causal): Q, K, P
        and V split into hi + lo by truncation as the kernel splits them,
        both products as three TF32 products summed exactly, the softmax
        in f32 (P unnormalised, divided by l at the end, as the kernel
        does), held against the plain f32 version at atol/rtol 2e-3.  At
        unit scale one TF32 term passes too, using 56% of the tolerance;
        at the Zamba2 prefill's scale (q and k x2, |v| up to ~100, a
        nearly one-hot softmax) it misses by 33x, where three products
        use 4%."""
        rng = np.random.default_rng(80)
        q, k = (torch.from_numpy(rng.standard_normal((1, 4, 128, 80))
                                 .astype(np.float32)) * qk_scale
                for _ in range(2))
        v = torch.from_numpy(rng.standard_normal((1, 4, 128, 80))
                             .astype(np.float32)) * v_scale
        want = flash_attention_plain(q, k, v, sm_scale=80 ** -0.5,
                                     causal=True, kv_len=128)

        def product(a, b, eq, three):
            if not three:
                return torch.einsum(eq, _trunc(a).double(),
                                    _trunc(b).double()).float()
            (ah, al), (bh, bl) = _split(a), _split(b)
            return sum(torch.einsum(eq, x.double(), y.double())
                       for x, y in ((ah, bl), (al, bh), (ah, bh))).float()

        def emulated(three):
            s = product(q, k, "bhqd,bhkd->bhqk", three) * 80 ** -0.5
            causal = torch.ones((128, 128), dtype=torch.bool).tril()
            s = torch.where(causal, s, torch.full_like(s, -1e30))
            p = torch.exp(s - s.amax(-1, keepdim=True))
            return product(p, v, "bhqk,bhkd->bhqd", three) \
                / p.sum(-1, keepdim=True)

        torch.testing.assert_close(emulated(True), want, atol=2e-3,
                                   rtol=2e-3)
        one_ok = torch.allclose(emulated(False), want, atol=2e-3, rtol=2e-3)
        assert one_ok != one_misses


SHAPES = ((8, 12), (13, 9), (16, 16), (24, 20))


def _maps(seed, n, h, w, p_link=0.5):
    rng = np.random.default_rng(seed)
    score = rng.uniform(0.0, 1.0, (n, h, w)).astype(np.float32)
    links = (rng.uniform(0.0, 1.0, (n, h, w, 8)) < p_link).astype(np.float32)
    return score, links


class TestCCLabel:
    @pytest.mark.parametrize("hw", SHAPES)
    @pytest.mark.parametrize("p_link", [0.4, 0.6])
    def test_tiled_equals_pallas_and_log_hop(self, hw, p_link):
        score, links = _maps(hw[0] * hw[1], 2, *hw, p_link)
        got = cc_label_tiled(torch.from_numpy(score), torch.from_numpy(links),
                             th=8, tw=8, return_stats=True)
        sj, lj = jnp.asarray(score), jnp.asarray(links)
        want = cc_label_pallas(sj, lj, th=8, tw=8, interpret=True,
                               return_stats=True)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        ref = jpp.cc_label_batched(sj, lj, hop="log")
        assert np.array_equal(got[0].numpy(), np.asarray(ref))

    def test_valid_mask_and_padding(self):
        n, h, w = 3, 24, 20
        score, links = _maps(11, n, h, w, 0.6)
        mask = np.zeros((n, h, w), bool)
        for i, (vh, vw) in enumerate(((24, 20), (17, 13), (8, 20))):
            mask[i, :vh, :vw] = True
        got = cc_label_tiled(torch.from_numpy(score), torch.from_numpy(links),
                             valid_mask=torch.from_numpy(mask), th=8, tw=8,
                             return_stats=True)
        want = cc_label_pallas(jnp.asarray(score), jnp.asarray(links),
                               valid_mask=jnp.asarray(mask), th=8, tw=8,
                               interpret=True, return_stats=True)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        assert (got[0].numpy()[~mask] == 0).all()

    def test_tile_crossing_component(self):
        score = np.zeros((1, 16, 16), np.float32)
        score[0, 8, :] = 1.0
        score[0, :, 8] = 1.0
        links = np.ones((1, 16, 16, 8), np.float32)
        got = cc_label_tiled(torch.from_numpy(score),
                             torch.from_numpy(links), th=8, tw=8).numpy()
        want = np.asarray(cc_label_pallas(jnp.asarray(score),
                                          jnp.asarray(links), th=8, tw=8,
                                          interpret=True))
        assert np.array_equal(got, want)
        assert len(np.unique(got[0][score[0] > 0.5])) == 1

    @pytest.mark.parametrize("case", [0, 1] + [
        pytest.param((name, th, tw), id=f"{name}-{th}x{tw}")
        for name in cc_cases.CASES for th, tw in ((8, 8), (8, 24), (32, 32))])
    def test_local_spread_plain_matches_kernel(self, case):
        """Phase 1 alone: labels equal the reference kernel's, on random
        symmetrized maps (seeds 0 and 1, 8x8 tiles) and on the three
        inputs of ``data/cc_cases`` (links that are not symmetric, dirty
        labels, a serpentine) at three tile shapes; the per-tile Jacobi
        round counts of the plain loop, which chip_smoke prints, are at
        least 1, and about half the tile's pixels on the serpentine."""
        if isinstance(case, int):
            score, links = _maps(case, 2, 16, 24, 0.7)
            pos = score > 0.5
            lnk = np.asarray(jpp.link_symmetrize(jnp.asarray(links))) > 0.5
            args = (cc_cases.init_labels(pos), pos.astype(np.int32),
                    lnk.astype(np.int32))
            name, th, tw = "random", 8, 8
        else:
            name, th, tw = case
            args = cc_cases.make_case(name, th + tw, 2, 2 * th, 2 * tw, th,
                                      tw)
        targs = [torch.from_numpy(a) for a in args]
        got = local_spread_converge_plain(*targs, th=th, tw=tw)
        want = j_local(*(jnp.asarray(a) for a in args), th=th, tw=tw,
                       interpret=True)
        assert np.array_equal(got.numpy(), np.asarray(want))
        same, rounds = local_spread_jacobi(*targs, th=th, tw=tw)
        assert torch.equal(same, got)
        n, h, w = args[0].shape
        assert rounds.shape == (n, h // th, w // tw)
        assert int(rounds.min()) >= 1
        if name == "serpentine":
            assert int(rounds.min()) > th * tw // 2 - th

    def test_link_symmetrize_wraps_around(self):
        """The reciprocal link is read with a wrap-around roll, as in the
        reference (not with a zero-filled shift)."""
        links = np.zeros((4, 5, 8), np.float32)
        links[0, 0, 0] = 1.0          # up-left of (0, 0) wraps to (3, 4)
        got = pp.link_symmetrize(torch.from_numpy(links)).numpy()
        want = np.asarray(jpp.link_symmetrize(jnp.asarray(links)))
        assert np.array_equal(got, want) and got[3, 4, 7] == 1.0


def _meta_calls():
    meta = torch.device("meta")
    f32 = dict(device=meta, dtype=torch.float32)
    i32 = dict(device=meta, dtype=torch.int32)
    i16 = dict(device=meta, dtype=torch.int16)
    return {
        "winograd_tiles": lambda: winograd_tiles(
            torch.empty((1, 8, 8, 3), **f32), torch.empty((36, 3, 5), **f32)),
        "bfp_matmul_quantized": lambda: bfp_matmul_quantized(
            torch.empty((4, 40), **i16), torch.empty((4, 2), **i32),
            torch.empty((40, 3), **i16), torch.empty((3, 2), **i32)),
        "local_spread_converge": lambda: local_spread_converge(
            torch.empty((1, 8, 8), **i32), torch.empty((1, 8, 8), **i32),
            torch.empty((1, 8, 8, 8), **i32), th=8, tw=8),
    }


@pytest.mark.parametrize("name", sorted(_meta_calls()))
def test_wrapper_refuses_other_devices(name):
    """A wrapper runs its plain version only for CPU tensors: on any other
    non-CUDA device it raises instead of falling back."""
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        _meta_calls()[name]()
    assert kernels.launch_counts()[name] == 0
