"""repro_torch's STD training stack against the JAX package's: STDLoss,
gradients through the engine's reference datapath, the optimizers and
schedules, gradient utilities, checkpoints (within the port and across
the two packages), TrainRunner, the compressed gradient sum, and three
steps of ``launch/train_std``.  Inputs and weights are NumPy-seeded
(the weights in the shapes of the JAX model's own tree) and cross to the
port by ``params_from_numpy``.

Tolerances:
  * STDLoss values: rtol 1e-6 (the same f32 formula; sums in another
    order).
  * Gradients of STDLoss o apply (VGG-16 and ResNet-50 PixelLink, width
    0.125, 64x64, reference mode): per leaf, max abs error at most 1e-4
    x the leaf's max |g| (the convolutions and their transposes sum in
    another order); the BN leaves, which ``apply`` never reads, exactly
    zero in both.
  * Optimizers over 5 steps of shared gradients: params within 1e-6
    abs + 1e-6 rel; the bfp8 first moment's mantissas and exponents
    bit-equal.
  * Schedules at 20 steps, the compressed sum, error feedback and the
    checkpoints: bit-equal.
  * Three train_std steps: losses within 1e-5 relative, params within
    1e-4 x the leaf's max |p|.
"""
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.core import bfp as jbfp
from repro.models.fcn import PixelLinkModel as JPixelLinkModel
from repro.models.fcn import STDLoss as JSTDLoss
from repro.models.fcn.pixellink import STDConfig as JSTDConfig
from repro.optim import adamw as j_adamw
from repro.optim import constant as j_constant
from repro.optim import cosine_with_warmup as j_cosine
from repro.optim import linear_warmup as j_linear
from repro.optim import sgd_momentum as j_sgd
from repro.optim.grad_utils import GradAccumulator as JGradAccumulator
from repro.optim.grad_utils import clip_by_global_norm as j_clip
from repro.optim.grad_utils import error_feedback_compress as j_ef
from repro.optim.optimizers import OptState as JOptState
from repro.runtime.collectives import psum_bytes_model as j_psum_bytes
from repro_torch.checkpoint import (CheckpointManager, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core import bfp
from repro_torch.core import tree as tree_lib
from repro_torch.data.images import SyntheticSTDData
from repro_torch.launch import train_std
from repro_torch.models.fcn import PixelLinkModel, STDLoss, params_from_numpy
from repro_torch.optim import (GradAccumulator, OptState, adamw,
                               clip_by_global_norm, constant,
                               cosine_with_warmup, error_feedback_compress,
                               global_norm, init_residual, linear_warmup,
                               sgd_momentum, value_and_grad)
from repro_torch.runtime.collectives import compressed_psum, \
    psum_bytes_model
from repro_torch.runtime.fault_tolerance import (PreemptionGuard,
                                                 TrainRunner, Watchdog)

torch.set_num_threads(2)

BN_LEAVES = ("gamma", "beta", "mean", "var")


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _bits(x) -> np.ndarray:
    """The bytes of an array or tensor (bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return np.atleast_1d(x.numpy()).view(np.uint8)
    return np.atleast_1d(np.asarray(x)).view(np.uint8)


# ---------------------------------------------------------------------------
# STDLoss
# ---------------------------------------------------------------------------

def _loss_inputs(seed, n=2, h=8, w=8, p_pos=0.4):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, h, w, 9)).astype(np.float32) * 3
    score = (rng.random((n, h, w)) < p_pos).astype(np.float32)
    links = (rng.random((n, h, w, 8)) > 0.5).astype(np.float32)
    return logits, score, links


@pytest.mark.parametrize("seed,p_pos,neg_ratio", [
    (0, 0.4, 3.0), (1, 0.05, 3.0), (2, 0.9, 1.0), (3, 0.0, 3.0)])
def test_std_loss_equals_reference(seed, p_pos, neg_ratio):
    """Balanced and skewed positives, a budget above the negatives, and
    no positive pixel at all."""
    logits, score, links = _loss_inputs(seed, p_pos=p_pos)
    want = JSTDLoss(neg_ratio)({"logits": jnp.asarray(logits)},
                               jnp.asarray(score), jnp.asarray(links))
    got = STDLoss(neg_ratio)({"logits": torch.from_numpy(logits)},
                             torch.from_numpy(score),
                             torch.from_numpy(links))
    for k in ("loss", "score_loss", "link_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-6, atol=0)


def test_link_loss_is_the_masked_element_mean():
    """The reference's normalization oracle: positive pixels x 8
    channels in the denominator."""
    logits, score, links = _loss_inputs(7)
    got = STDLoss()({"logits": torch.from_numpy(logits)},
                    torch.from_numpy(score), torch.from_numpy(links))
    lg = logits[..., 1:]
    bce = np.maximum(lg, 0) - lg * links + np.log1p(np.exp(-np.abs(lg)))
    mask = (score > 0.5).astype(np.float32)[..., None]
    want = (bce * mask).sum() / (mask.sum() * lg.shape[-1])
    assert float(got["link_loss"]) == pytest.approx(want, rel=1e-5)


# ---------------------------------------------------------------------------
# gradients through the engine's reference datapath
# ---------------------------------------------------------------------------

def _cfg(pkg_cfg, backbone):
    return pkg_cfg(backbone=backbone, width=0.125, image_size=(64, 64),
                   merge_ch=(16, 16, 8), mode="reference",
                   storage_fp16=False)


def numpy_params(jm, seed=0):
    """Weights for the JAX model ``jm`` drawn by NumPy in the shapes of its
    own parameter tree: He-normal ``w``, zero biases and BN shifts, unit
    BN scales, and BN statistics away from identity so that folding them
    changes the weights."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    out = {}
    for name, leaves in sorted(shapes.items()):
        p = {}
        for k, sd in sorted(leaves.items()):
            shape = tuple(sd.shape)
            if k == "w":
                fan_in = int(np.prod(shape[:-1]))
                v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
            elif k in ("gamma", "var"):
                v = rng.uniform(0.5, 1.5, shape)
            elif k == "mean":
                v = rng.normal(0.0, 0.1, shape)
            else:
                v = np.zeros(shape)
            p[k] = jnp.asarray(v.astype(np.float32))
        out[name] = p
    return out


@pytest.fixture(scope="module", params=["vgg16", "resnet50"])
def grad_pair(request):
    """(backbone, JAX model, its params, jitted value_and_grad of the
    loss, port model)."""
    backbone = request.param
    jm = JPixelLinkModel(_cfg(JSTDConfig, backbone))
    jparams = numpy_params(jm)
    loss = JSTDLoss()

    def f(p, x, sg, lg):
        return loss(jm.apply(p, x), sg, lg)["loss"]

    return (backbone, jm, jparams, jax.jit(jax.value_and_grad(f)),
            PixelLinkModel(_cfg(train_std.STDConfig, backbone), "cpu"))


def test_gradients_equal_jax_grad(grad_pair):
    backbone, _, jparams, jgrad, model = grad_pair
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)) \
        .astype(np.float32)
    sg = (np.random.default_rng(2).random((2, 16, 16)) > 0.7) \
        .astype(np.float32)
    lg = (np.random.default_rng(3).random((2, 16, 16, 8)) > 0.5) \
        .astype(np.float32)
    jloss, jg = jgrad(jparams, jnp.asarray(x), jnp.asarray(sg),
                      jnp.asarray(lg))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    loss, g = value_and_grad(
        lambda p: STDLoss()(model.apply(p, torch.from_numpy(x)),
                            torch.from_numpy(sg), torch.from_numpy(lg))
        ["loss"], params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert set(g) == set(jg)
    n_bn = 0
    for name, leaves in jg.items():
        assert set(g[name]) == set(leaves)
        for k, want in leaves.items():
            want = np.asarray(want)
            got = g[name][k].numpy()
            assert got.shape == want.shape and np.isfinite(got).all()
            if k in BN_LEAVES:
                n_bn += 1
                assert not want.any() and not got.any(), (name, k)
                continue
            scale = float(np.abs(want).max())
            assert scale > 0, (name, k)
            err = float(np.abs(got - want).max())
            assert err <= 1e-4 * scale, (backbone, name, k, err, scale)
    assert n_bn > 0


def test_kernel_wrappers_refuse_autograd():
    """K1, K2 and K3 have no backward: given an operand that requires
    grad they raise, and the optimized datapath raises with them; under
    no_grad they run."""
    from repro_torch.kernels.bfp_matmul import bfp_matmul
    from repro_torch.kernels.cc_label import cc_label_tiled
    from repro_torch.kernels.winograd_conv import winograd_conv2d

    x = torch.from_numpy(_normal(0, (1, 8, 8, 4)))
    w = torch.from_numpy(_normal(1, (3, 3, 4, 5))).requires_grad_(True)
    a = torch.from_numpy(_normal(2, (8, 32))).requires_grad_(True)
    b = torch.from_numpy(_normal(3, (32, 4)))
    score = torch.rand(1, 16, 16).requires_grad_(True)
    links = torch.rand(1, 16, 16, 8)
    calls = [lambda: winograd_conv2d(x, w),
             lambda: bfp_matmul(a, b),
             lambda: cc_label_tiled(score, links)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
    model = PixelLinkModel(train_std.STDConfig(
        backbone="vgg16", width=0.125, image_size=(32, 32),
        merge_ch=(8, 8, 8), mode="optimized", storage_fp16=False), "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    live = tree_lib.tree_map(lambda p: p.requires_grad_(True), params)
    with pytest.raises(RuntimeError, match="no backward"):
        model.apply(live, torch.zeros(1, 32, 32, 3))


def test_serving_builds_no_graph():
    """Trainable parameters handed to a service: its engines run under
    no_grad, so its maps carry no graph and its boxes come out."""
    from repro_torch.launch.serve import STDService

    svc = STDService(width=0.125, buckets=(32,), device="cpu",
                     merge_ch=(8, 8, 8))
    params = tree_lib.tree_map(lambda p: p.clone().requires_grad_(True),
                               svc.factory.params((32, 32)))
    svc.factory.set_params(params)
    fn = svc.factory.plan_fn((32, 32), 1)
    x = torch.rand(1, 32, 32, 3)
    vq = torch.full((1, 2), 8, dtype=torch.int32)
    maps = fn.forward(svc.factory.params((32, 32)), x)
    labels, converged = fn(svc.factory.params((32, 32)), x, vq)
    assert not any(t.requires_grad for t in maps.values())
    assert not labels.requires_grad and bool(converged.all())
    assert isinstance(svc(np.random.default_rng(0).random((30, 28, 3))
                          .astype(np.float32)), list)


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

def _opt_params():
    return {"w": _normal(10, (4, 64)), "b": {"c": _normal(11, (40,))}}


def _run_optimizer(pkg, make, steps=5):
    """Five updates of the same gradients; returns (params, state) of
    either package as numpy trees."""
    p0 = _opt_params()
    grads = [{"w": _normal(20 + i, (4, 64)),
              "b": {"c": _normal(40 + i, (40,))}} for i in range(steps)]
    if pkg == "jax":
        init, update = make[0]()
        params = jax.tree_util.tree_map(jnp.asarray, p0)
        st = init(params)
        for g in grads:
            params, st = update(jax.tree_util.tree_map(jnp.asarray, g), st,
                                params)
        return params, st
    init, update = make[1]()
    params = tree_lib.tree_map(torch.from_numpy, p0)
    st = init(params)
    for g in grads:
        params, st = update(tree_lib.tree_map(torch.from_numpy, g), st,
                            params)
    return params, st


OPTIMIZERS = {
    f"adamw-{md}": (lambda md=md: j_adamw(1e-2, moment_dtype=md,
                                          weight_decay=0.1),
                    lambda md=md: adamw(1e-2, moment_dtype=md,
                                        weight_decay=0.1))
    for md in ("float32", "bfloat16", "bfp8")}
OPTIMIZERS["adamw-cosine"] = (
    lambda: j_adamw(j_cosine(3e-3, 2, 5), weight_decay=1e-4),
    lambda: adamw(cosine_with_warmup(3e-3, 2, 5), weight_decay=1e-4))
OPTIMIZERS["sgd_momentum"] = (lambda: j_sgd(5e-2, weight_decay=1e-3),
                              lambda: sgd_momentum(5e-2, weight_decay=1e-3))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_equal_reference(name):
    jp, jst = _run_optimizer("jax", OPTIMIZERS[name])
    tp, tst = _run_optimizer("torch", OPTIMIZERS[name])
    for want, got in zip(jax.tree_util.tree_leaves(jp),
                         tree_lib.leaves(tp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    assert int(tst.step) == int(jst.step) == 5
    jmu = jax.tree_util.tree_leaves(jst.mu)
    tmu = tree_lib.leaves(tst.mu)
    assert len(jmu) == len(tmu)
    if name == "adamw-bfp8":
        # mantissas and exponents of the BFP8 first moment, bit for bit
        assert isinstance(tst.mu["w"], bfp.BFPTensor)
        for want, got in zip(jmu, tmu):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert tst.nu["w"].dtype == torch.bfloat16
    else:
        for want, got in zip(jmu, tmu):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("md", ["float32", "bfloat16", "bfp8"])
def test_adamw_converges(md):
    target = torch.from_numpy(_normal(0, (4, 32)))
    init, update = adamw(1e-1, moment_dtype=md, weight_decay=0.0)
    params = {"w": torch.zeros(4, 32)}
    st = init(params)
    for _ in range(200):
        _, g = value_and_grad(
            lambda p: torch.mean((p["w"] - target) ** 2), params)
        params, st = update(g, st, params)
    assert float((params["w"] - target).abs().max()) < 0.06


def test_bfp8_moment_memory_model():
    init, _ = adamw(1e-3, moment_dtype="bfp8")
    st = init({"w": torch.zeros(64, 512)})
    assert isinstance(st.mu["w"], bfp.BFPTensor)
    assert st.mu["w"].nbytes_model() == 64 * 512 + 64 * 16
    assert st.nu["w"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        adamw(1e-3, moment_dtype="fp8")


SCHEDULES = {
    "constant": (j_constant(3e-3), constant(3e-3)),
    "linear_warmup": (j_linear(1e-3, 7), linear_warmup(1e-3, 7)),
    "cosine_6b": (j_cosine(3e-3, 5, 20), cosine_with_warmup(3e-3, 5, 20)),
    "cosine_long": (j_cosine(1e-3, 10, 100),
                    cosine_with_warmup(1e-3, 10, 100)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_equals_reference(name):
    jf, tf = SCHEDULES[name]
    for s in range(21):
        want = np.float32(jf(jnp.asarray(s, jnp.int32)))
        got = tf(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.ndim == 0
        assert np.float32(got.item()) == want, (s, float(got), float(want))


# ---------------------------------------------------------------------------
# gradient utilities
# ---------------------------------------------------------------------------

def test_clip_by_global_norm_equals_reference():
    g = {"a": _normal(0, (10,), 10.0), "b": {"c": _normal(1, (3, 4))}}
    jc, jn = j_clip(jax.tree_util.tree_map(jnp.asarray, g), 1.0)
    tc, tn = clip_by_global_norm(tree_lib.tree_map(torch.from_numpy, g),
                                 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for want, got in zip(jax.tree_util.tree_leaves(jc), tree_lib.leaves(tc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    assert abs(float(global_norm(tc)) - 1.0) < 1e-5 and float(tn) > 20
    small, n = clip_by_global_norm({"a": torch.ones(4) * 1e-3}, 1.0)
    assert torch.equal(small["a"], torch.ones(4) * 1e-3)


@pytest.mark.parametrize("n_micro", [1, 4])
def test_grad_accumulation_equals_reference(n_micro):
    x, y = _normal(0, (8, 4)), _normal(1, (8, 4))

    def jloss(p, b):
        return jnp.mean((p["w"] * b["x"] - b["y"]) ** 2)

    def tloss(p, b):
        return torch.mean((p["w"] * b["x"] - b["y"]) ** 2)

    jl, jg = JGradAccumulator(n_micro)(
        jloss, {"w": jnp.asarray(2.0)},
        {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    tl, tg = GradAccumulator(n_micro)(
        tloss, {"w": torch.tensor(2.0)},
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(tg["w"]), float(jg["w"]), rtol=1e-6)
    l1, g1 = value_and_grad(tloss, {"w": torch.tensor(2.0)},
                            {"x": torch.from_numpy(x),
                             "y": torch.from_numpy(y)})
    assert abs(float(l1) - float(tl)) < 1e-6
    assert abs(float(g1["w"]) - float(tg["w"])) < 1e-6


def test_value_and_grad_zeros_for_unread_leaves():
    params = {"used": torch.ones(3), "unused": {"gamma": torch.ones(2)}}
    (loss, aux), g = value_and_grad(
        lambda p: (torch.sum(p["used"] * 2.0), {"n": torch.tensor(3.0)}),
        params, has_aux=True)
    assert float(loss) == 6.0 and float(aux["n"]) == 3.0
    assert torch.equal(g["used"], torch.full((3,), 2.0))
    assert torch.equal(g["unused"]["gamma"], torch.zeros(2))
    assert not params["used"].requires_grad


def test_error_feedback_equals_reference_and_conserves():
    """The compressed gradients and residuals bit-equal the reference's
    over 30 steps, and nothing is lost: sum(q) + r == sum(g)."""
    jr = {"w": jnp.zeros((8, 64))}
    tr = init_residual({"w": torch.zeros(8, 64)})
    tot_q, tot_g = torch.zeros(8, 64), torch.zeros(8, 64)
    for i in range(30):
        g = _normal(100 + i, (8, 64))
        jq, jr = j_ef({"w": jnp.asarray(g)}, jr, mantissa_bits=4)
        q, tr = error_feedback_compress({"w": torch.from_numpy(g)}, tr,
                                        mantissa_bits=4)
        np.testing.assert_array_equal(q["w"].numpy(), np.asarray(jq["w"]))
        np.testing.assert_array_equal(tr["w"].numpy(), np.asarray(jr["w"]))
        tot_q += q["w"]
        tot_g += torch.from_numpy(g)
    assert float((tot_q + tr["w"] - tot_g).abs().max()) < 1e-3
    g = {"w": torch.from_numpy(_normal(0, (32, 128)))}
    errs = [float((error_feedback_compress(g, init_residual(g),
                                           mantissa_bits=mb)[0]["w"]
                   - g["w"]).abs().mean()) for mb in (3, 7, 12)]
    assert errs == sorted(errs, reverse=True)


# ---------------------------------------------------------------------------
# compressed gradient sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mantissa_bits", [7, 12])
def test_compressed_psum_equals_reference_sequence(mantissa_bits):
    """Eight host slots: each slot's sum bit-equals the reference's
    quantize, narrow to the wire type, dequantize and add-in-slot-order
    sequence (its all-gather + fori_loop), and is within 5% of the exact
    sum."""
    xs = [_normal(200 + i, (4, 64)) for i in range(8)]
    wire = jnp.int8 if mantissa_bits <= 7 else jnp.int16
    acc = jnp.zeros((4, 64), jnp.float32)
    for x in xs:
        q = jbfp.quantize(jnp.asarray(x), block_size=32,
                          mantissa_bits=mantissa_bits, axis=-1,
                          rounding="nearest")
        t = jbfp.BFPTensor(q.mantissa.astype(wire).astype(jnp.int32),
                           q.exponent.astype(jnp.int32), mantissa_bits, 32,
                           1)
        acc = acc + jbfp.dequantize(t)
    outs = compressed_psum([torch.from_numpy(x) for x in xs],
                           mantissa_bits=mantissa_bits)
    assert len(outs) == 8
    for out in outs:
        np.testing.assert_array_equal(out.numpy(), np.asarray(acc))
    exact = np.sum(xs, axis=0)
    rel = np.abs(outs[0].numpy() - exact).max() / np.abs(exact).max()
    assert rel < 0.05
    with pytest.raises(ValueError):
        compressed_psum([torch.zeros(2, 32), torch.zeros(3, 32)])


@pytest.mark.parametrize("nbytes,n,mb", [(4 * 2 ** 20, 16, 7),
                                         (4096, 8, 12), (1 << 30, 2, 7)])
def test_psum_bytes_model_equals_reference(nbytes, n, mb):
    want = j_psum_bytes(nbytes, n, compressed=True, mantissa_bits=mb)
    got = psum_bytes_model(nbytes, n, compressed=True, mantissa_bits=mb)
    assert got == want
    if mb == 7 and n == 16:
        assert got[1] < got[0] / 4


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _j_tree():
    """The reference test's tree: bf16 and f32 params and an AdamW state
    with bfp8 moments after one update."""
    init, update = j_adamw(1e-2, moment_dtype="bfp8")
    params = {"a": jnp.arange(12.0).reshape(3, 4).astype(jnp.bfloat16),
              "b": {"c": jnp.ones((5,))}}
    st = init(params)
    g = jax.tree_util.tree_map(lambda x: jnp.ones(x.shape, jnp.float32),
                               params)
    params, st = update(g, st, params)
    return {"params": params, "opt": st}


def _to_port(x):
    """A reference tree -> the port's, leaf for leaf, bf16 as bits."""
    from repro_torch.models.lm.params import _tensor_from_numpy

    if isinstance(x, dict):
        return {k: _to_port(v) for k, v in x.items()}
    if isinstance(x, JOptState):
        return OptState(*[_to_port(v) for v in x])
    if isinstance(x, jbfp.BFPTensor):
        return bfp.BFPTensor(_to_port(x.mantissa), _to_port(x.exponent),
                             x.mantissa_bits, x.block_size, x.axis)
    if x is None:
        return None
    return _tensor_from_numpy(np.asarray(x), "cpu")


def _t_tree():
    init, update = adamw(1e-2, moment_dtype="bfp8")
    params = {"a": torch.arange(12.0).reshape(3, 4).to(torch.bfloat16),
              "b": {"c": torch.ones(5)}}
    st = init(params)
    g = tree_lib.tree_map(lambda x: torch.ones(x.shape), params)
    params, st = update(g, st, params)
    return {"params": params, "opt": st}


def _assert_bit_equal(got, want):
    a, b = tree_lib.leaves(got), tree_lib.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_checkpoint_leaf_keys_equal_reference():
    from repro.checkpoint.checkpoint import _flatten_with_keys as j_keys
    from repro_torch.checkpoint.checkpoint import _flatten_with_keys

    jt, tt = _j_tree(), _t_tree()
    assert [k for k, _ in _flatten_with_keys(tt)] == \
        [k for k, _ in j_keys(jt)[0]]
    assert "opt__mu_a__<flat index 0>" in dict(_flatten_with_keys(tt))


def test_checkpoint_roundtrip_bitwise():
    tree = _t_tree()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 7, tree, blocking=True)
        _assert_bit_equal(restore_checkpoint(d, 7, tree), tree)
        with open(os.path.join(d, "step_7", "manifest.json")) as f:
            import json
            manifest = json.load(f)
        assert set(manifest) == {"step", "treedef", "leaves", "meta"}
        assert {r["dtype"] for r in manifest["leaves"]} == \
            {"bfloat16", "float32", "int32"}


def test_checkpoint_crosses_packages_bit_equal():
    """Saved by the reference, restored by the port; and the reverse."""
    jt = _j_tree()
    pt = _to_port(jt)
    _assert_bit_equal(pt, pt)
    with tempfile.TemporaryDirectory() as d:
        j_save(d, 3, jt, blocking=True)
        _assert_bit_equal(restore_checkpoint(d, 3, pt), pt)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 4, pt, blocking=True)
        got = j_restore(d, 4, jt)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(jt)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(_bits(a), _bits(b))
    # the port's own update of the same tree gives the same leaves
    _assert_bit_equal(_t_tree(), pt)


def test_checkpoint_retention_async_and_crash_during_save():
    tree = _t_tree()
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, keep=2)
        for s in (1, 2, 3, 4):
            cm.save(s, tree, blocking=True)
        assert cm.steps() == [3, 4] and cm.latest_step() == 4
        cm.save(5, tree, blocking=False)
        cm.wait()
        assert cm.latest_step() == 5
        os.makedirs(os.path.join(d, "step_6.tmp"))
        assert cm.latest_step() == 5          # a staging dir is no step


def test_orphaned_tmp_dirs_pruned_on_init():
    with tempfile.TemporaryDirectory() as d:
        orphan = os.path.join(d, "step_5.tmp-999-0")
        os.makedirs(orphan)
        save_checkpoint(d, 7, {"w": torch.ones(2)}, blocking=True)
        mgr = CheckpointManager(d)
        assert not os.path.exists(orphan)
        assert mgr.steps() == [7]


def test_shape_mismatch_rejected():
    tree = _t_tree()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree, blocking=True)
        bad = tree_lib.tree_map(lambda x: torch.zeros((9, 9), dtype=x.dtype),
                                tree)
        with pytest.raises(ValueError, match="shape"):
            restore_checkpoint(d, 1, bad)


def test_elastic_restore_onto_mesh_devices():
    """A tree of devices (one mesh slot per leaf group) places each leaf;
    a device tree that does not match is refused."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh((1, 2), device="cpu")
    tree = {"w": torch.arange(16.0).reshape(4, 4), "v": torch.ones(3)}
    devs = {"w": mesh.device_at(data=0, model=1), "v": "cpu"}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 1, tree, blocking=True)
        got = restore_checkpoint(d, 1, tree, device=devs)
        assert torch.equal(got["w"], tree["w"])
        assert got["w"].device == mesh.device_at(data=0, model=1)
        with pytest.raises(ValueError, match="device tree"):
            restore_checkpoint(d, 1, tree, device={"w": "cpu"})


# ---------------------------------------------------------------------------
# TrainRunner
# ---------------------------------------------------------------------------

def _step_fn(state, batch):
    p, s = state
    loss, g = value_and_grad(lambda w: torch.mean((w - batch) ** 2), p)
    return (p - 0.1 * g, s + 1), {"loss": loss}


def _batch_fn(step):
    return torch.from_numpy(np.random.default_rng(step).normal(size=(4,))
                            .astype(np.float32))


def _state0():
    return (torch.zeros(4), torch.zeros((), dtype=torch.int32))


def test_crash_resume_bit_exact():
    with tempfile.TemporaryDirectory() as d:
        r = TrainRunner(_step_fn, _batch_fn, CheckpointManager(d),
                        ckpt_every=5)
        with pytest.raises(RuntimeError, match="injected"):
            r.run(_state0(), 0, 20, fail_at=13)
        r2 = TrainRunner(_step_fn, _batch_fn, CheckpointManager(d),
                         ckpt_every=5)
        start, state = r2.resume_or_init(_state0())
        assert start == 10
        _, resumed, status = r2.run(state, start, 20 - start)
        assert status == "done"
    direct = _state0()
    for i in range(20):
        direct, _ = _step_fn(direct, _batch_fn(i))
    assert torch.equal(resumed[0], direct[0])
    assert int(resumed[1]) == 20


def test_preemption_checkpoint_and_stop():
    guard = PreemptionGuard(install=False)
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d)
        r = TrainRunner(_step_fn, _batch_fn, cm, ckpt_every=100,
                        guard=guard)
        step, state, status = r.run(_state0(), 0, 3)
        assert (step, status) == (3, "done")
        guard.request()
        step, state, status = r.run(state, step, 100)
        assert status == "preempted" and cm.latest_step() == step == 3
        assert r.metrics_log[-1]["step"] == 3


def test_straggler_triggers_incident_hook():
    incidents = []
    slow_once = {"done": False}

    def step(state, batch):
        if int(state[1]) == 5 and not slow_once["done"]:
            slow_once["done"] = True
            time.sleep(0.3)
        return _step_fn(state, batch)

    with tempfile.TemporaryDirectory() as d:
        r = TrainRunner(step, _batch_fn, CheckpointManager(d),
                        ckpt_every=100,
                        watchdog=Watchdog(threshold=5.0, warmup_steps=2),
                        on_incident=incidents.append)
        r.run(_state0(), 0, 10)
    assert len(incidents) >= 1 and incidents[0]["step"] == 6


def test_pixellink_crash_resume_bit_exact():
    """The train_std step through TrainRunner (VGG-16 PixelLink, width
    0.125, 32x32, batch 2, AdamW): 8 steps crashing after 5, resumed from
    the step-3 checkpoint, bit-equal to 8 uninterrupted steps in params
    and optimizer state."""
    cfg = train_std.make_config(width=0.125, size=32, merge_ch=(8, 8, 8))
    model = PixelLinkModel(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    opt_init, opt_update = adamw(cosine_with_warmup(3e-3, 2, 8),
                                 weight_decay=1e-4, moment_dtype="bfp8")
    step = train_std.make_train_step(model, STDLoss(), opt_update)
    data = SyntheticSTDData((32, 32), max_instances=2, seed=0)

    def batch_fn(i):
        return train_std.batch_on(data.sample(i, 2), "cpu")

    state0 = (params, opt_init(params))
    with tempfile.TemporaryDirectory() as d:
        r = TrainRunner(step, batch_fn, CheckpointManager(d), ckpt_every=3)
        with pytest.raises(RuntimeError, match="injected"):
            r.run(state0, 0, 8, fail_at=5)
        r2 = TrainRunner(step, batch_fn, CheckpointManager(d), ckpt_every=3)
        start, state = r2.resume_or_init(state0)
        assert start == 3
        _, resumed, _ = r2.run(state, start, 8 - start)
    direct = state0
    for i in range(8):
        direct, _ = step(direct, batch_fn(i))
    _assert_bit_equal(resumed, direct)
    losses = [m["loss"] for m in r.metrics_log]
    assert all(np.isfinite(losses))


# ---------------------------------------------------------------------------
# train_std against the reference example
# ---------------------------------------------------------------------------

def test_train_std_steps_equal_reference():
    """Three steps of the example's configuration (width 0.125 here),
    AdamW with weight decay 1e-4 and cosine_with_warmup(3e-3, 10, 150),
    on the same batches from the same NumPy-drawn weights."""
    from repro.data.images import SyntheticSTDData as JData

    jcfg = JSTDConfig(backbone="vgg16", width=0.125, image_size=(64, 64),
                      merge_ch=(16, 16, 8), mode="reference",
                      storage_fp16=False)
    jm = JPixelLinkModel(jcfg)
    jparams = numpy_params(jm)
    jloss = JSTDLoss(neg_ratio=3.0)
    j_init, j_update = j_adamw(j_cosine(3e-3, 10, 150), weight_decay=1e-4)

    @jax.jit
    def jstep(params, opt, images, score_gt, link_gt):
        def L(p):
            d = jloss(jm.apply(p, images), score_gt, link_gt)
            return d["loss"], d

        (_, d), g = jax.value_and_grad(L, has_aux=True)(params)
        params, opt = j_update(g, opt, params)
        return params, opt, d

    model = PixelLinkModel(train_std.make_config(width=0.125, size=64),
                           "cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    opt_init, opt_update = adamw(cosine_with_warmup(3e-3, 10, 150),
                                 weight_decay=1e-4)
    step = train_std.make_train_step(model, STDLoss(neg_ratio=3.0),
                                     opt_update)
    state = (params, opt_init(params))
    jopt = j_init(jparams)
    data = JData((64, 64), max_instances=3, seed=0)
    for i in range(3):
        b = data.sample(i, 4)
        jparams, jopt, jd = jstep(jparams, jopt, jnp.asarray(b["images"]),
                                  jnp.asarray(b["score"]),
                                  jnp.asarray(b["links"]))
        state, d = step(state, train_std.batch_on(b, "cpu"))
        for k in ("loss", "score_loss", "link_loss"):
            np.testing.assert_allclose(float(d[k]), float(jd[k]), rtol=1e-5)
    for name, leaves in jparams.items():
        for k, want in leaves.items():
            want = np.asarray(want)
            got = state[0][name][k].numpy()
            scale = float(np.abs(want).max())
            assert float(np.abs(got - want).max()) <= 1e-4 * scale, (name, k)
    assert int(state[1].step) == 3
