"""repro_torch core against the JAX reference: microcode bytes, golden
disassemblies, the memory plan, BFP encodings (bit-equal), Winograd and
the fused upsample, and XLA "SAME" padding for convs and pools."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import bfp as jbfp
from repro.core import fuse as jfuse
from repro.core import winograd as jwg
from repro.core.memplan import plan_disassembly as j_plan_disassembly
from repro.core.microcode import pack_program as j_pack_program
from repro.models.fcn import DetectionModel as JDetectionModel
from repro.models.fcn import build_head as j_build_head
from repro.models.fcn.pixellink import STDConfig as JSTDConfig
from repro_torch.core import bfp, fuse, winograd
from repro_torch.core.memplan import plan_disassembly
from repro_torch.core.microcode import pack_program
from repro_torch.models.fcn import DetectionModel, STDConfig, build_head

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def golden_cfg(cls, **kw):
    return cls(name="pixellink_vgg16", backbone="vgg16", width=0.125,
               image_size=(64, 64), merge_ch=(16, 16, 8), mode="reference",
               storage_fp16=False, **kw)


@pytest.fixture(scope="module")
def programs():
    port = DetectionModel(golden_cfg(STDConfig), build_head("pixellink"),
                          device="cpu").program
    ref = JDetectionModel(golden_cfg(JSTDConfig),
                          j_build_head("pixellink")).program
    return port, ref


class TestMicrocode:
    def test_pack_program_bit_equal(self, programs):
        port, ref = programs
        got = pack_program(port.words)
        assert got.dtype == np.uint8 and got.shape == (len(ref.words), 32)
        assert np.array_equal(got, j_pack_program(ref.words))

    def test_disassembly_matches_golden(self, programs):
        with open(os.path.join(GOLDEN_DIR, "microcode_pixellink.txt")) as f:
            assert f.read() == programs[0].disassemble() + "\n"

    def test_memplan_disassembly_matches_golden(self, programs):
        path = os.path.join(GOLDEN_DIR, "microcode_pixellink_memplan.txt")
        with open(path) as f:
            assert f.read() == plan_disassembly(programs[0]) + "\n"
        assert plan_disassembly(programs[0], dtype_bytes=2) == \
            j_plan_disassembly(programs[1], dtype_bytes=2)

    def test_bindings_and_shapes_equal(self, programs):
        port, ref = programs
        assert port.weight_bindings == ref.weight_bindings
        assert port.addr_shapes == ref.addr_shapes
        assert port.outputs == ref.outputs


def _bfp_inputs(seed):
    """Normal values with exact zeros, an all-zero block, a remainder
    block (the last axis is not a multiple of 32) and subnormals."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 5, 77)) *
         np.exp2(rng.integers(-20, 20, (3, 5, 77)))).astype(np.float32)
    x[0, 0, :32] = 0.0                     # all-zero block
    x[1, 2, ::7] = 0.0                     # scattered zeros
    x[2, 4, 64:] = 0.0                     # all-zero remainder block
    x[2, 3, 3] = np.float32(1e-40)         # subnormal, flushed to zero
    x[2, 3, 40:72] = np.float32(-3e-39)    # a block of subnormals
    return x


class TestBFP:
    @pytest.mark.parametrize("rounding", ["trunc", "nearest"])
    @pytest.mark.parametrize("mantissa_bits", [7, 10])
    @pytest.mark.parametrize("axis", [-1, 0, 1])
    def test_encodings_bit_equal(self, rounding, mantissa_bits, axis):
        x = _bfp_inputs(mantissa_bits + axis)
        kw = dict(block_size=32, mantissa_bits=mantissa_bits, axis=axis,
                  rounding=rounding)
        q = bfp.quantize(torch.from_numpy(x), **kw)
        jq = jbfp.quantize(jnp.asarray(x), **kw)
        assert np.array_equal(q.mantissa.numpy(), np.asarray(jq.mantissa))
        assert np.array_equal(q.exponent.numpy(), np.asarray(jq.exponent))
        assert q.axis == jq.axis
        got = bfp.dequantize(q).numpy()
        assert np.array_equal(got, np.asarray(jbfp.dequantize(jq)))

    def test_exp2i_exact(self):
        e = torch.arange(-140, 140, dtype=torch.int32)
        want = np.asarray(jbfp.exp2i(jnp.asarray(e.numpy())))
        assert np.array_equal(bfp.exp2i(e).numpy(), want)

    def test_roundtrip_weights_along_cin(self):
        w = np.random.default_rng(3).standard_normal((3, 3, 40, 6)) \
            .astype(np.float32)
        got = bfp.roundtrip(torch.from_numpy(w), axis=-2).numpy()
        want = np.asarray(jbfp.roundtrip(jnp.asarray(w), axis=-2))
        assert np.array_equal(got, want)


class TestWinogradAndFuse:
    @pytest.mark.parametrize("shape,padding", [
        ((2, 9, 13, 5, 7), "SAME"), ((1, 8, 8, 4, 4), "SAME"),
        ((2, 7, 10, 3, 2), "VALID")])
    def test_winograd_conv2d(self, shape, padding):
        n, h, w, cin, cout = shape
        rng = np.random.default_rng(h * w)
        x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
        k = rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
        got = winograd.winograd_conv2d(torch.from_numpy(x),
                                       torch.from_numpy(k), padding).numpy()
        want = np.asarray(jwg.winograd_conv2d(jnp.asarray(x), jnp.asarray(k),
                                              padding=padding))
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)

    def test_upsample_fused_equals_naive_and_reference(self):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
        w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        fused = fuse.upsample2x_conv3x3_fused(xt, wt).numpy()
        np.testing.assert_allclose(
            fused, fuse.upsample2x_conv3x3_naive(xt, wt).numpy(), atol=1e-5)
        np.testing.assert_allclose(
            fused, np.asarray(jfuse.upsample2x_conv3x3_fused(
                jnp.asarray(x), jnp.asarray(w))), atol=1e-5)

    @pytest.mark.parametrize("k,s,hw", [(3, 1, (9, 10)), (3, 2, (8, 8)),
                                        (7, 2, (12, 9)), (1, 2, (7, 6))])
    def test_conv_same_padding_matches_xla(self, k, s, hw):
        """XLA's SAME pads the extra row/column at the end for strides
        above 1 (the ResNet-50 stem and strided 3x3 words)."""
        rng = np.random.default_rng(k * s)
        x = rng.standard_normal((1, *hw, 3)).astype(np.float32)
        w = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
        got = fuse.conv2d_nhwc(torch.from_numpy(x), torch.from_numpy(w),
                               s, "SAME").numpy()
        want = np.asarray(lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")))
        np.testing.assert_allclose(got, want, atol=1e-4)

    @pytest.mark.parametrize("kind", ["max", "avg"])
    @pytest.mark.parametrize("k,s,hw", [(2, 2, (8, 8)), (2, 2, (7, 9)),
                                        (3, 2, (8, 7))])
    def test_pool_same_padding_matches_xla(self, kind, k, s, hw):
        x = np.random.default_rng(k + s).standard_normal((2, *hw, 3)) \
            .astype(np.float32)
        got = fuse.pool_nhwc(torch.from_numpy(x), k, s, kind).numpy()
        if kind == "max":
            init, op = -jnp.inf, lax.max
        else:
            init, op = 0.0, lax.add
        want = lax.reduce_window(jnp.asarray(x), init, op, (1, k, k, 1),
                                 (1, s, s, 1), "SAME")
        if kind == "avg":
            want = want / (k * k)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)

    def test_fold_batchnorm(self):
        rng = np.random.default_rng(9)
        w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
        g, b, m = (rng.standard_normal(5).astype(np.float32)
                   for _ in range(3))
        v = rng.uniform(0.5, 2.0, 5).astype(np.float32)
        got = fuse.fold_batchnorm(*(torch.from_numpy(a)
                                    for a in (w, b, g, b, m, v)))
        want = jfuse.fold_batchnorm(*(jnp.asarray(a)
                                      for a in (w, b, g, b, m, v)))
        for a, c in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-6)
