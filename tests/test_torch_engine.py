"""repro_torch's FCNEngine over the golden PixelLink program against the
JAX engine, with the reference's weights carried over by binding name,
on the VGG-16, ResNet-50 and MobileNet trunks.

Tolerances: reference/f32 atol 1e-4 and optimized/f32 atol 1e-3 (f32
sums in another order, Winograd in the optimized mode).  Optimized/bfp
with FP16 storage: every BFP conv quantizes bit-equal inputs to
bit-equal encodings (test_torch_core), but the two engines sum each
conv in another order, so an f32 result that lands near an FP16 rounding
boundary can round one ulp apart; the next BFP quantization turns that
ulp into one mantissa LSB of the block, about 2^-10 of the block's
largest value.  Over the 30 words of the program those steps add up to
an end-of-net delta of 1.5e-2 on logits of magnitude 3.4 and 3.7e-3 on
the probabilities.  The stated tolerance is 5e-2 on logits, 2e-2 on
the probability maps (sigmoid slope <= 1/4) and 2e-3 on their mean.
MobileNet is held to VGG-16's numbers.

ResNet-50 in bfp/FP16 is the same cascade over 81 words, 16 of them
residual adds that let the values grow (|logits| up to L = 38.1 here,
against 3.4 for VGG-16); ``test_resnet50_bfp_word_walk`` walks both
engines word by word on this build.  The first word whose FP16 output
differs is word 4, ``s1b1_c2`` (3 of 4,096 values, one ulp); the first
more than one ulp away, and the first conv whose input BFP encodings
differ, is word 9, ``s1b2_c3``.  Fed the reference's own inputs, every
word of the port is within one FP16 ulp of the word's largest value of
the reference's output (in ulps of the values themselves at most 255,
at ``head_prob``: the reference takes the sigmoid in FP16, the port in
f32), so no word of the port is at fault.  The reference against
itself, every conv's f32 result moved by a relative 2^-22 (another sum
order), moves its logits by 0.1875, as far as the port's are from it:
the port's deltas (logits 0.19, score 1.9e-2, links 2.8e-2; 4.9e-3 of L,
as VGG-16's 1.5e-2 is 4.4e-3 of its 3.4) are the reference's own
sensitivity to sum order.  Since each step is one mantissa LSB
relative to its block, the end-of-net delta scales with the logits, and
the ResNet-50 tolerance is stated in units of L = max |reference
logits|: 1e-2 L on logits (twice the 4.9e-3 L seen here), 2.5e-3 L on
the maps (the sigmoid's slope is at most 1/4) and 2.5e-4 L on their
mean (a quarter of 1e-3 L, twice the mean logit delta of about 5e-4 L
seen here, 4.7e-4 L, and between the full-width model at 512x512 on an
H100 and on the CPU in chip_smoke, 5.6e-4 L).  In those units that is
tighter than VGG-16's tolerance (1.5e-2 L, 6e-3 L and 6e-4 L).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BFPConfig as JBFPConfig
from repro.models.fcn import DetectionModel as JDetectionModel
from repro.models.fcn import build_head as j_build_head
from repro.models.fcn import postprocess as jpp
from repro.models.fcn.pixellink import STDConfig as JSTDConfig
from repro_torch.core import BFPConfig
from repro_torch.models.fcn import (
    DetectionModel, STDConfig, build_head, params_from_numpy)
from repro_torch.models.fcn import postprocess as pp

torch.set_num_threads(2)

MODES = {
    # mode, bfp, storage_fp16 -> (atol logits, atol maps, atol map mean)
    ("reference", False, False): (1e-4, 1e-4, 1e-4),
    ("optimized", False, False): (1e-3, 1e-3, 1e-3),
    ("optimized", True, True): (5e-2, 2e-2, 2e-3),
}
# ResNet-50 in bfp/FP16, in units of L = max |reference logits|
RESNET_BFP_TOL = (1e-2, 2.5e-3, 2.5e-4)
# VGG-16's cases keep their ids
CASES = [pytest.param("vgg16", *m, id="-".join(map(str, m))) for m in MODES]
CASES += [pytest.param(bb, *m, id="-".join(map(str, (bb,) + m)))
          for bb in ("resnet50", "mobilenet") for m in MODES]


@functools.lru_cache(maxsize=None)
def _ref_params(backbone, bfp):
    """The reference's ``PRNGKey(0)`` weights of the golden build on one
    trunk (normalized for bfp) and the port's copy, drawn once per file:
    the eager init takes most of a ResNet-50 case's time."""
    ref, port = _models("optimized", bfp, bfp, backbone=backbone)
    jp = ref.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    if bfp:
        jp, tp = ref.normalize_weights(jp), port.normalize_weights(tp)
    return jp, tp


def _tolerance(backbone, mode, bfp, fp16, want_logits):
    if backbone == "resnet50" and bfp:
        scale = float(np.abs(want_logits).max())
        return tuple(t * scale for t in RESNET_BFP_TOL)
    return MODES[(mode, bfp, fp16)]


def _models(mode, bfp, fp16, memplan=True, backbone="vgg16"):
    kw = dict(name=f"pixellink_{backbone}", backbone=backbone, width=0.125,
              image_size=(64, 64), merge_ch=(16, 16, 8), mode=mode,
              storage_fp16=fp16, memplan=memplan)
    ref = JDetectionModel(JSTDConfig(bfp=JBFPConfig() if bfp else None,
                                     **kw), j_build_head("pixellink"))
    port = DetectionModel(STDConfig(bfp=BFPConfig() if bfp else None, **kw),
                          build_head("pixellink"), device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)) \
        .astype(np.float32)


@pytest.mark.parametrize("backbone,mode,bfp,fp16", CASES)
def test_engine_matches_reference(backbone, mode, bfp, fp16, images,
                                  request):
    """The observed max and mean |delta| per map are kept in the test's
    ``user_properties`` (``max_abs_delta_<map>``, ``mean_abs_delta_<map>``;
    the junit XML shows them).  Boxes decoded from one shared set of maps (the reference's)
    are equal: the port's CC labels of them are bit-equal to the
    reference's."""
    ref, port = _models(mode, bfp, fp16, backbone=backbone)
    jp, tp = _ref_params(backbone, bfp)
    want = jax.jit(ref.apply)(jp, jnp.asarray(images))
    got = port.apply(tp, torch.from_numpy(images))
    atol_logits, atol_maps, atol_mean = _tolerance(
        backbone, mode, bfp, fp16, np.asarray(want["logits"]))
    for name, atol in (("logits", atol_logits), ("score", atol_maps),
                       ("links", atol_maps)):
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape and g.dtype == np.float32
        request.node.user_properties += [
            (f"max_abs_delta_{name}", float(np.abs(g - w).max())),
            (f"mean_abs_delta_{name}", float(np.abs(g - w).mean()))]
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)
        if name != "logits":
            assert np.abs(g - w).mean() <= atol_mean
    score, links = np.array(want["score"]), np.array(want["links"])
    labels = pp.cc_label_batched(torch.from_numpy(score),
                                 torch.from_numpy(links)).numpy()
    assert np.array_equal(labels, np.asarray(jpp.cc_label_batched(
        jnp.asarray(score), jnp.asarray(links))))
    for lab in labels:
        assert pp.boxes_from_labels(lab) == jpp.boxes_from_labels(lab)


@pytest.mark.parametrize("bfp", [False, True], ids=["f32", "bfp"])
def test_resnet50_memplan_off_is_bitwise_equal(bfp, images):
    """ResNet-50 under the memory plan (fusion facts, buffers and the
    residual cache dropped at last use) and without it: bit-equal maps."""
    fp16 = bfp
    _, planned = _models("optimized", bfp, fp16, backbone="resnet50")
    _, legacy = _models("optimized", bfp, fp16, memplan=False,
                        backbone="resnet50")
    params = planned.init_params(torch.Generator().manual_seed(0))
    if bfp:
        params = planned.normalize_weights(params)
    a = planned.apply(params, torch.from_numpy(images))
    b = legacy.apply(params, torch.from_numpy(images))
    assert planned.engine.memplan is not None and legacy.engine.memplan is None
    for k in a:
        assert torch.equal(a[k], b[k])


def test_memplan_off_is_bitwise_equal(images):
    _, planned = _models("optimized", False, False)
    _, legacy = _models("optimized", False, False, memplan=False)
    params = planned.init_params(torch.Generator().manual_seed(0))
    a = planned.apply(params, torch.from_numpy(images))
    b = legacy.apply(params, torch.from_numpy(images))
    for k in a:
        assert torch.equal(a[k], b[k])


def test_transposed_mode_matches_reference(images):
    """The §IV.B transpose trick: transposed kernels on the transposed
    plane, as the reference runs them."""
    ref, port = _models("reference", False, False)
    jp = ref.init_params(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    xt = np.ascontiguousarray(images.transpose(0, 2, 1, 3))
    want = jax.jit(ref.apply, static_argnames="transposed")(
        jp, jnp.asarray(xt), transposed=True)
    got = port.apply(tp, torch.from_numpy(xt), transposed=True)
    for name in ("logits", "score", "links"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=1e-4, rtol=0)


def test_init_is_seeded_and_shaped():
    _, port = _models("reference", False, False)
    a = port.init_params(torch.Generator().manual_seed(0))
    b = port.init_params(torch.Generator().manual_seed(0))
    assert a.keys() == b.keys()
    for name in a:
        for k in a[name]:
            assert torch.equal(a[name][k], b[name][k])
    ref, _ = _models("reference", False, False)
    shapes = jax.tree_util.tree_map(np.shape,
                                    ref.init_params(jax.random.PRNGKey(0)))
    assert {n: {k: tuple(v.shape) for k, v in leaves.items()}
            for n, leaves in a.items()} == shapes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cc_label_batched_matches_reference(seed):
    rng = np.random.default_rng(seed)
    score = rng.uniform(0, 1, (3, 13, 17)).astype(np.float32)
    links = (rng.uniform(0, 1, (3, 13, 17, 8)) < 0.5).astype(np.float32)
    mask = np.ones((3, 13, 17), bool)
    mask[1, 9:] = False
    for hop, max_iters in (("log", 256), ("one", 256), ("one", 5)):
        got = pp.cc_label_batched(torch.from_numpy(score),
                                  torch.from_numpy(links),
                                  max_iters=max_iters,
                                  valid_mask=torch.from_numpy(mask),
                                  hop=hop, return_stats=True)
        want = jpp.cc_label_batched(jnp.asarray(score), jnp.asarray(links),
                                    max_iters=max_iters,
                                    valid_mask=jnp.asarray(mask), hop=hop,
                                    return_stats=True)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    labels = got[0].numpy()[0]
    assert pp.boxes_from_labels(labels) == jpp.boxes_from_labels(labels)
    assert pp.boxes_from_labels(labels) == \
        pp.boxes_from_labels_reference(labels)
    one = pp.cc_label_numpy(score[0], links[0])
    assert np.array_equal(one, jpp.cc_label_numpy(score[0], links[0]))


def _all_outputs(model):
    """Make every word's output a program output (memplan off)."""
    prog = model.program
    prog.outputs.clear()
    prog.outputs.update({prog.layer_specs[i].name: mc.out_addr
                         for i, mc in enumerate(prog.words)})
    return prog


def test_resnet50_bfp_word_walk(images, request):
    """The word-by-word account of ResNet-50's bfp delta (module
    docstring).  Both engines run the golden ResNet-50 build with every
    word's output kept; then every word of the port runs again on the
    reference's own inputs and residual register.  Fed the same inputs,
    each port word's FP16 output is within one FP16 ulp of the largest
    value of the reference's, so no word is at fault and the
    free-running delta is the cascade.  The reference against itself,
    with every conv's f32 result moved by a relative 2^-22 (alternating
    signs: what another sum order does), moves its logits at least half
    as far as the port's are from it.  Recorded in ``user_properties``:
    the first word whose free-running FP16 output differs, the first more
    than one ulp away, the first conv whose input BFP encodings differ,
    the largest teacher-forced delta in ulps of the values themselves
    (and its word), and both end-of-net logit deltas."""
    from repro_torch.core import bfp as tbfp
    from repro_torch.core.assembler import STORAGE_BYTES
    from repro_torch.core.microcode import ExtOp, LayerType, ResOp

    ref, port = _models("optimized", True, True, memplan=False,
                        backbone="resnet50")
    prog = _all_outputs(port)
    _all_outputs(ref)
    jp, tp = _ref_params("resnet50", True)
    want = {k: np.array(v, np.float32) for k, v in
            jax.jit(ref.engine.__call__)(jp, jnp.asarray(images)).items()}
    free = {k: v.float().numpy()
            for k, v in port.engine(tp, torch.from_numpy(images)).items()}
    arenas = {"ref": {prog.input_addr: images},
              "free": {prog.input_addr: images}}
    extents = {prog.input_addr: images[0].size * STORAGE_BYTES}
    for i, mc in enumerate(prog.words):
        name = prog.layer_specs[i].name
        arenas["ref"][mc.out_addr] = want[name]
        arenas["free"][mc.out_addr] = free[name]
        extents[mc.out_addr] = int(np.prod(prog.addr_shapes[mc.out_addr])) \
            * STORAGE_BYTES

    def read(arena, addr, ch):
        parts, got = [], 0
        while got < ch:                 # a concat read walks the regions
            parts.append(arena[addr])
            got += arena[addr].shape[-1]
            addr += extents[addr]
        return torch.from_numpy(np.concatenate(parts, -1))

    def ulps(a, b):
        spacing = np.spacing(np.maximum(np.abs(a), np.abs(b))
                             .astype(np.float16)).astype(np.float32)
        return float((np.abs(a - b) / spacing).max())

    def encodings(x):
        q = tbfp.quantize(x.float(), axis=-1)
        return q.mantissa, q.exponent

    eng, cache = port.engine, None
    first_diff = first_free = first_enc = None
    worst = (0.0, "")
    for i, mc in enumerate(prog.words):
        spec = prog.layer_specs[i]
        x = read(arenas["ref"], mc.in_addr, mc.in_ch)
        p = tp.get(prog.weight_bindings.get(i, ""), {})
        lt, fused = LayerType(mc.layer_type), False
        if lt == LayerType.CONV:
            fused = bool(mc.relu) and mc.res_op == ResOp.NONE
            y = eng._conv(x, p, mc, spec, relu=fused)
            mine = encodings(read(arenas["free"], mc.in_addr, mc.in_ch))
            if first_enc is None and not all(
                    torch.equal(a, b) for a, b in zip(mine, encodings(x))):
                first_enc = spec.name
        elif lt == LayerType.POOL:
            y = eng._pool(x, mc, spec)
        elif lt == LayerType.UPSAMPLE:
            y = eng._upsample(x, p, spec)
        elif ExtOp(mc.ext_opcode) == ExtOp.SIGMOID:
            y = torch.sigmoid(x.float())
        else:
            assert ExtOp(mc.ext_opcode) == ExtOp.IDENTITY
            y = x
        if mc.res_op == ResOp.CACHE:
            cache = y
        elif mc.res_op == ResOp.ADD:
            y = y + cache
        if mc.relu and not fused:
            y = torch.relu(y)
        got = y.to(torch.float16).float().numpy()
        theirs = want[spec.name]
        top = np.spacing(np.float16(np.abs(theirs).max())).astype(np.float32)
        assert np.abs(got - theirs).max() <= top, (i, spec.name)
        worst = max(worst, (ulps(got, theirs), spec.name))
        d = free[spec.name] != theirs
        if first_diff is None and d.any():
            first_diff = (f"{i} {spec.name}: {int(d.sum())} of {d.size} "
                          f"values, {ulps(free[spec.name], theirs):.0f} ulp")
        if first_free is None and ulps(free[spec.name], theirs) > 1:
            first_free = f"{i} {spec.name}"

    orig = ref.engine._conv

    def moved(x, p, mc, spec, **kw):
        y = orig(x, p, mc, spec, **kw)
        sign = 1.0 - 2.0 * (jnp.arange(y.size).reshape(y.shape) % 2)
        return y * (1.0 + sign * 2.0 ** -22)

    ref.engine._conv = moved
    self_moved = np.array(jax.jit(ref.engine.__call__)(
        jp, jnp.asarray(images))["head_logits"], np.float32)
    end = want["head_logits"]
    port_delta = float(np.abs(free["head_logits"] - end).max())
    self_delta = float(np.abs(self_moved - end).max())
    request.node.user_properties += [
        ("first_word_differing", first_diff),
        ("first_word_over_one_ulp", first_free),
        ("first_conv_with_other_encodings", first_enc),
        ("teacher_forced_max_ulps", f"{worst[0]:.0f} at {worst[1]}"),
        ("port_logit_delta", port_delta),
        ("reference_self_logit_delta", self_delta)]
    assert first_free is not None and first_enc is not None
    assert port_delta <= 2 * self_delta
