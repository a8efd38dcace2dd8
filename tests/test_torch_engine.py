"""repro_torch's FCNEngine over the golden PixelLink program against the
JAX engine, with the reference's weights carried over by binding name.

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
"""
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


def _models(mode, bfp, fp16, memplan=True):
    kw = dict(name="pixellink_vgg16", backbone="vgg16", width=0.125,
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


@pytest.mark.parametrize("mode,bfp,fp16", list(MODES))
def test_engine_matches_reference(mode, bfp, fp16, images, request):
    """The observed max |delta| per map is kept in the test's
    ``user_properties`` (``max_abs_delta_<map>``; the junit XML shows
    them)."""
    ref, port = _models(mode, bfp, fp16)
    jp = ref.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    if bfp:
        jp, tp = ref.normalize_weights(jp), port.normalize_weights(tp)
    want = jax.jit(ref.apply)(jp, jnp.asarray(images))
    got = port.apply(tp, torch.from_numpy(images))
    atol_logits, atol_maps, atol_mean = MODES[(mode, bfp, fp16)]
    for name, atol in (("logits", atol_logits), ("score", atol_maps),
                       ("links", atol_maps)):
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape and g.dtype == np.float32
        request.node.user_properties.append(
            (f"max_abs_delta_{name}", float(np.abs(g - w).max())))
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)
        if name != "logits":
            assert np.abs(g - w).mean() <= atol_mean


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
