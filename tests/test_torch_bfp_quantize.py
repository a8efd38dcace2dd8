"""The BFP quantize wrapper (``kernels/bfp_quantize``) on the CPU: it runs
``core/bfp.py``'s torch ops there and under autograd, launches nothing
and counts nothing; and the kernel's integer steps, as
``csrc/bfp_quantize.cu`` takes them from the bits, mirrored in NumPy and
held bit-equal to ``core/bfp.py`` on the edge cases (the kernel itself
is held to ``core/bfp.py`` on the card, ``tests/test_torch_cuda.py``)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs.pixellink_std import RESNET50, VGG16
from repro_torch.core import bfp
from repro_torch.kernels.bfp_quantize import bfp_quantize, quantize, roundtrip
from repro_torch.kernels.bfp_quantize.ops import view_shape
from repro_torch.models.fcn import DetectionModel, build_head
from repro_torch.runtime.telemetry import SPANS

from _bfp_cases import AXES, DTYPES, KS, bfp_values, shape_for

torch.set_num_threads(2)


def kernel_steps(x: torch.Tensor, *, axis: int, block_size: int = 32,
                 mantissa_bits: int = 10, rounding: str = "trunc"):
    """The kernel's steps in NumPy: the exponent and the truncated
    mantissa from the f32 bits (a zero exponent field is a zero), the
    block max, ``d = min(xi - e, 31)``, the half ulp, the arithmetic
    shift and the value through the clamped ``exp2i``.  Returns
    ``(mantissa, exponent, value)`` laid out as ``core/bfp.py``'s."""
    xm = np.moveaxis(x.to(torch.float32).numpy(), axis, -1)
    k = xm.shape[-1]
    pad = (-k) % block_size
    xb = np.pad(xm, [(0, 0)] * (xm.ndim - 1) + [(0, pad)])
    xb = xb.reshape(*xm.shape[:-1], -1, block_size)
    bits = xb.view(np.uint32).astype(np.int64)
    ef = (bits >> 23) & 0xFF
    zero = ef == 0
    e = np.where(zero, -(1 << 30), ef - 126)
    xi = np.maximum(e.max(-1, keepdims=True), -(1 << 29))
    mag = ((bits & 0x7FFFFF) | 0x800000) >> (24 - mantissa_bits)
    mi = np.where(zero, 0, np.where(bits >> 31 == 1, -mag, mag))
    d = np.minimum(xi - e, 31)
    if rounding == "nearest":
        mi = mi + np.sign(mi) * np.where(d > 0, 1 << np.maximum(d - 1, 0), 0)
    q = mi >> d
    scale = ((np.clip(xi - mantissa_bits, -126, 127) + 127) << 23) \
        .astype(np.uint32).view(np.float32)
    val = q.astype(np.float32) * scale

    def back(a):
        a = a.reshape(*a.shape[:-2], -1)[..., :k]
        return np.moveaxis(a, -1, axis)

    return back(q), xi[..., 0], back(val)


@pytest.mark.parametrize("rounding", ["trunc", "nearest"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_wrapper_is_core_bfp(dtype, axis, k, rounding):
    """On CPU tensors the wrapper returns ``core/bfp.py``'s results
    exactly and launches nothing."""
    x = bfp_values(k + axis, shape_for(axis, k), dtype, axis)
    geo = dict(axis=axis, rounding=rounding)
    kernels.reset_launch_counts()
    SPANS.take()
    got = roundtrip(x, **geo)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, bfp.roundtrip(x.to(torch.float32), **geo))
    m, e = quantize(x, **geo)
    q = bfp.quantize(x, **geo)
    assert m.dtype == torch.int16 and e.dtype == torch.int32
    assert torch.equal(m, q.mantissa.to(torch.int16))
    assert torch.equal(e, q.exponent)
    assert kernels.launch_counts()["bfp_quantize"] == 0
    assert SPANS.take() == {}


@pytest.mark.parametrize("rounding", ["trunc", "nearest"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_steps_are_core_bfp(dtype, axis, k, rounding):
    """The kernel's bit-level steps give ``core/bfp.py``'s mantissas,
    exponents and roundtrip values, the subnormal flush, all-zero blocks,
    the ``exp2i`` clamp and steps below FP16's range included."""
    x = bfp_values(7 * k - axis, shape_for(axis, k), dtype, axis)
    q = bfp.quantize(x, axis=axis, rounding=rounding)
    m, e, v = kernel_steps(x, axis=axis, rounding=rounding)
    assert np.array_equal(m, q.mantissa.numpy())
    assert np.array_equal(e, q.exponent.numpy())
    assert np.array_equal(v, bfp.dequantize(q).numpy())


@pytest.mark.parametrize("mantissa_bits", [0, 7, 15, 24])
def test_kernel_steps_mantissa_widths(mantissa_bits):
    """From no mantissa bits to the kernel's widest, 24."""
    x = bfp_values(mantissa_bits, (4, 70), torch.float32, -1)
    q = bfp.quantize(x, mantissa_bits=mantissa_bits, rounding="nearest")
    m, e, v = kernel_steps(x, axis=-1, mantissa_bits=mantissa_bits,
                           rounding="nearest")
    assert np.array_equal(m, q.mantissa.numpy())
    assert np.array_equal(e, q.exponent.numpy())
    assert np.array_equal(v, bfp.dequantize(q).numpy())


@pytest.mark.parametrize("form", ["roundtrip", "quantize"])
def test_autograd_takes_core_bfp_ops(form):
    """Under ``requires_grad`` the wrapper is ``core/bfp.py``'s ops and
    counts nothing on the CPU."""
    x = bfp_values(5, (2, 6, 64), torch.float32, -1).requires_grad_(True)
    kernels.reset_launch_counts()
    SPANS.take()
    if form == "roundtrip":
        assert torch.equal(roundtrip(x, axis=-1), bfp.roundtrip(x, axis=-1))
    else:
        m, e = quantize(x, axis=-1)
        q = bfp.quantize(x, axis=-1)
        assert torch.equal(m, q.mantissa.to(torch.int16))
        assert torch.equal(e, q.exponent)
    assert kernels.launch_counts()["bfp_quantize"] == 0
    assert SPANS.take() == {}


@pytest.mark.parametrize("shape,axis,want", [
    ((2, 9, 9, 64), -1, (162, 64, 1)),
    ((3, 3, 64, 128), -2, (9, 64, 128)),
    ((256, 512), 0, (1, 256, 512)),
    ((7,), 0, (1, 7, 1))])
def test_view_shape(shape, axis, want):
    assert view_shape(shape, axis) == want


def test_launcher_refuses_cpu_and_bad_arguments():
    x = torch.ones((2, 32))
    with pytest.raises(ValueError):
        bfp_quantize(x, form="roundtrip")
    with pytest.raises(ValueError):
        bfp_quantize(x, form="dequantize")
    with pytest.raises(ValueError):
        quantize(x, mantissa_bits=16)
    assert "bfp_quantize" in kernels.wrappers()


@pytest.mark.parametrize("cfg", [VGG16, RESNET50], ids=["vgg16", "resnet50"])
def test_cpu_forward_counts_no_bfp(cfg):
    """A BFP forward on the CPU takes the torch ops: no launch, and no
    ``bfp.*`` count in the tally its engine call would hand to
    ``engine.run``."""
    model = DetectionModel(dataclasses.replace(
        cfg, width=0.125, image_size=(64, 64), merge_ch=(16, 16, 8)),
        build_head("pixellink"), "cpu")
    params = model.normalize_weights(
        model.init_params(torch.Generator().manual_seed(0)))
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (2, 64, 64, 3)).astype(np.float32))
    kernels.reset_launch_counts()
    SPANS.take()
    with torch.no_grad():
        out = model.apply(params, x)
    tally = SPANS.take()
    assert not any(k.startswith("bfp.") for k in tally)
    assert kernels.launch_counts()["bfp_quantize"] == 0
    assert bool(torch.isfinite(out["logits"]).all())
