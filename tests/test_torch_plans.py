"""repro_torch's execution plans on a CPU host mesh against the JAX
package's single-device full plane.

RowBand (2 and 4 bands), DataParallel (2 shards) and GridPlan (2x2) run
with every mesh slot on ``"cpu"``: one process drives all slots, the
bands walk the program in lockstep and trade rows at every spatial layer.
The reference's claim is band = full plane, so its side runs in process
on one device (``SingleDevice``).  The reference's weights are handed
over by binding name.  Tolerances are ``tests/test_torch_engine.py``'s:
f32 optimized 1e-3 on logits and maps, f32 reference 1e-4, bfp with FP16
storage 5e-2 / 2e-2 / 2e-3 (mean); label maps and boxes must be equal.
The 128x128 plane (batch 2) is the smallest that four bands of VGG-16
divide evenly (4 bands x stride 32).

The port's banded maps are bit-identical to its full plane at every
band count here, in "reference" and in "optimized" mode, where four
bands of a 128 plane reach the stride-16 layers with two rows a band:
before a Winograd conv each band extends to plane rows at multiples of
4, so its tiles are the full plane's (``test_band_delta_by_mode``).
The serving tests route
over-tall and over-wide requests through ``tall_plan=`` and
``planner=`` and compare boxes with the JAX service's on a unit mesh.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BFPConfig as JBFPConfig
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.launch.serve import STDService as JSTDService
from repro.models.fcn import DetectionModel as JDetectionModel
from repro.models.fcn import build_head as j_build_head
from repro.models.fcn.pixellink import STDConfig as JSTDConfig
from repro.runtime.executor import RowBand as JRowBand
from repro.runtime.planner import Planner as JPlanner
from repro_torch import kernels
from repro_torch.core import BFPConfig
from repro_torch.core.interpreter import finish
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import STDService
from repro_torch.models.fcn import (DetectionModel, STDConfig, build_head,
                                    params_from_numpy)
from repro_torch.models.fcn import postprocess as pp
from repro_torch.runtime.executor import (
    DataParallel, EngineFactory, GridPlan, RowBand, SingleDevice,
    band_height_unit, describe_plan, plan_bands, plan_batch_multiple,
    plan_kind, row_band_height_unit)
from repro_torch.runtime.planner import Planner

torch.set_num_threads(2)

HW = (128, 128)
BATCH = 2
# precision -> (atol logits, atol maps, atol map mean)
TOL = {("optimized", "f32"): (1e-3, 1e-3, 1e-3),
       ("reference", "f32"): (1e-4, 1e-4, 1e-4),
       ("optimized", "bfp"): (5e-2, 2e-2, 2e-3)}


def host_mesh(shape):
    return make_host_mesh(shape, ("data", "model"), device="cpu")


PLANS = {
    "row_band2": lambda: RowBand(host_mesh((1, 2))),
    "row_band4": lambda: RowBand(host_mesh((1, 4))),
    "data_parallel2": lambda: DataParallel(host_mesh((2, 1))),
    "grid2x2": lambda: GridPlan(host_mesh((2, 2))),
}


def _cfg(backbone, mode, precision):
    bfp = precision == "bfp"
    return dict(name=f"pixellink_{backbone}", backbone=backbone, width=0.125,
                image_size=HW, merge_ch=(16, 16, 8), mode=mode,
                storage_fp16=bfp), bfp


@functools.lru_cache(maxsize=None)
def _setup(backbone, mode, precision):
    """The JAX model's maps and CC labels of the test batch, and a port
    factory holding the same weights."""
    kw, bfp = _cfg(backbone, mode, precision)
    ref = JDetectionModel(JSTDConfig(bfp=JBFPConfig() if bfp else None,
                                     **kw), j_build_head("pixellink"))
    jp = ref.init_params(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    if bfp:
        jp = ref.normalize_weights(jp)
    x = images()
    want = {k: np.array(v)
            for k, v in jax.jit(ref.apply)(jp, jnp.asarray(x)).items()}

    def make_model(hw, precision_, model, device="cpu"):
        k = dict(kw, image_size=hw)
        return DetectionModel(STDConfig(bfp=BFPConfig() if bfp else None,
                                        use_kernels=bfp, **k),
                              build_head(model), device)

    fac = EngineFactory(make_model, device="cpu")
    fac.set_params(params_from_numpy(tree))
    return want, fac


def images():
    return np.random.default_rng(0).uniform(0, 1, (BATCH,) + HW + (3,)) \
        .astype(np.float32)


def _vq():
    return torch.tensor([[HW[0] // 4, HW[1] // 4], [28, 30]],
                        dtype=torch.int32)


def _check_maps(got, want, tol, request, tag):
    atol_logits, atol_maps, atol_mean = tol
    for name, atol in (("logits", atol_logits), ("score", atol_maps),
                       ("links", atol_maps)):
        g, w = got[name].numpy(), want[name]
        assert g.shape == w.shape
        d = np.abs(g - w)
        request.node.user_properties.append(
            (f"{tag}_max_abs_delta_{name}", float(d.max())))
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)
        if name != "logits":
            assert d.mean() <= atol_mean


def _want_labels(want):
    vq = _vq().numpy()
    mask = ((np.arange(HW[0] // 4)[None, :, None] < vq[:, 0, None, None])
            & (np.arange(HW[1] // 4)[None, None, :] < vq[:, 1, None, None]))
    return pp.cc_label_batched(torch.from_numpy(want["score"]),
                               torch.from_numpy(want["links"]),
                               valid_mask=torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("precision", ["f32", "bfp"])
@pytest.mark.parametrize("plan_name", list(PLANS))
def test_plan_matches_reference_full_plane(plan_name, precision, request):
    """Each plan's maps within the engine tolerance of the JAX package's
    single-device maps, its labels equal to the CC labelling of the JAX
    maps, and its boxes equal."""
    want, fac = _setup("vgg16", "optimized", precision)
    plan = PLANS[plan_name]()
    params = fac.params(HW, precision)
    fn = fac.plan_fn(HW, BATCH, plan, precision)
    x = torch.from_numpy(images())
    _check_maps(fn.forward(params, x), want, TOL[("optimized", precision)],
                request, plan_name)
    labels, converged = fn(params, x, _vq())
    assert labels.shape == (BATCH, HW[0] // 4, HW[1] // 4)
    assert bool(converged.all())
    want_labels = _want_labels(want)
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    for i in range(BATCH):
        assert pp.boxes_from_labels(labels[i].numpy()) == \
            pp.boxes_from_labels(want_labels[i])
    assert describe_plan(plan) in [e["plan"] for e in
                                   fac.stats["compiled"]]


@pytest.mark.parametrize("bands", [2, 4])
def test_resnet50_row_band_matches_full_plane(bands, request):
    """ResNet-50's strided layers band too: the 7x7/2 stem takes an
    8-row halo and the 3x3/2 max-pool a 4-row one of zeros (as in the
    reference, not -inf: the pool reads post-ReLU values)."""
    want, fac = _setup("resnet50", "optimized", "f32")
    params = fac.params(HW, "f32")
    x = torch.from_numpy(images())
    fn = fac.plan_fn(HW, BATCH, RowBand(host_mesh((1, bands))), "f32")
    _check_maps(fn.forward(params, x), want, TOL[("optimized", "f32")],
                request, f"resnet50_row_band{bands}")
    full = fac.plan_fn(HW, BATCH, SingleDevice(), "f32")(params, x, _vq())
    labels, converged = fn(params, x, _vq())
    assert torch.equal(labels, full[0]) and bool(converged.all())


@pytest.mark.parametrize("mode", ["reference", "optimized"])
def test_band_delta_by_mode(mode, request):
    """The reference says band outputs are bit-identical to the full plane
    in "reference" mode and wherever band offsets keep the Winograd tiles
    aligned.  The port's bands are bit-identical at 2 and 4 bands in both
    modes: 4 bands leave offsets of 2 rows at stride 16, and the tile
    alignment of the exchange (``collectives.halo_bounds``) keeps the
    Winograd tiles the full plane's there too."""
    want, fac = _setup("vgg16", mode, "f32")
    params = fac.params(HW, "f32")
    x = torch.from_numpy(images())
    full = fac.plan_fn(HW, BATCH, SingleDevice(), "f32").forward(params, x)
    _check_maps(full, want, TOL[(mode, "f32")], request, "single")
    for bands in (2, 4):
        got = fac.plan_fn(HW, BATCH, RowBand(host_mesh((1, bands))),
                          "f32").forward(params, x)
        delta = max(float((got[k] - full[k]).abs().max())
                    for k in ("logits", "score", "links"))
        request.node.user_properties.append(
            (f"{mode}_row_band{bands}_max_abs_delta", delta))
        assert delta == 0.0, (mode, bands, delta)


def test_launch_counts_per_band():
    """Each band runs the whole program: on the CPU the wrappers run their
    plain versions and count nothing, so the counts stay 0 (the card's
    17 x bands / 7 x bands / 1 are tests/test_torch_cuda.py's)."""
    _, fac = _setup("vgg16", "optimized", "bfp")
    kernels.reset_launch_counts()
    fac.plan_fn(HW, BATCH, RowBand(host_mesh((1, 2))), "bfp")(
        fac.params(HW, "bfp"), torch.from_numpy(images()), _vq())
    assert set(kernels.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# plan validation and the plan-keyed LRU
# ---------------------------------------------------------------------------

def _stub_factory(capacity):
    fac = EngineFactory(lambda hw, precision="f32", model="pixellink": None,
                        capacity=capacity, device="cpu")
    fac._compile = (lambda hw, batch, plan, precision="f32",
                    model="pixellink": (lambda *a: None))
    fac.engine_weight_bytes = lambda *a, **k: 0
    return fac


def test_engine_lru_keyed_on_plan():
    fac = _stub_factory(16)
    unit = host_mesh((1, 1))
    single = fac.plan_fn((64, 64), 2, SingleDevice())
    assert fac.plan_fn((64, 64), 2, SingleDevice()) is single
    dp = fac.plan_fn((64, 64), 2, DataParallel(unit))
    rb = fac.plan_fn((64, 64), 2, RowBand(unit))
    gr = fac.plan_fn((64, 64), 2, GridPlan(unit))
    assert len({id(f) for f in (single, dp, rb, gr)}) == 4
    assert fac.plan_fn((64, 64), 2, GridPlan(host_mesh((1, 1)))) is gr
    assert fac.plan_fn((64, 64), 2, SingleDevice(), "bfp") is not single
    assert len(fac) == 5
    assert fac.engines.hits == 2 and fac.engines.misses == 5
    with pytest.raises(TypeError, match="unknown execution plan"):
        fac.plan_fn((64, 64), 2, object())


def test_plan_helpers():
    m = host_mesh((2, 4))
    assert [plan_batch_multiple(p) for p in (
        SingleDevice(), RowBand(m), DataParallel(m), GridPlan(m))] == \
        [1, 1, 2, 2]
    assert [plan_bands(p) for p in (
        SingleDevice(), RowBand(m), DataParallel(m), GridPlan(m),
        RowBand(m, bands=8))] == [1, 4, 1, 4, 8]
    assert band_height_unit(SingleDevice(), 32) == 32
    assert band_height_unit(GridPlan(m), 32) == 128
    assert row_band_height_unit(RowBand(m, bands=8), 32) == 256
    assert [plan_kind(p) for p in (
        SingleDevice(), DataParallel(m), RowBand(m), GridPlan(m))] == \
        ["single_device", "data_parallel", "row_band", "grid"]
    assert [describe_plan(p) for p in (
        SingleDevice(), DataParallel(m), RowBand(m), GridPlan(m))] == \
        ["single_device", "data_parallel[data=2]", "row_band[model=4]",
         "grid[data=2,model=4]"]
    with pytest.raises(TypeError):
        plan_kind(object())


def test_plans_reject_what_they_cannot_run():
    _, fac = _setup("vgg16", "optimized", "f32")
    unit, m22 = host_mesh((1, 1)), host_mesh((2, 2))
    with pytest.raises(ValueError, match="bands"):
        fac.plan_fn((64, 64), 1, RowBand(unit, bands=2))
    with pytest.raises(ValueError, match="band height"):
        fac.plan_fn((64, 64), 1, RowBand(host_mesh((1, 4))))
    with pytest.raises(ValueError, match="no axis"):
        fac.plan_fn((64, 64), 2, DataParallel(unit, "nope"))
    with pytest.raises(ValueError, match="divisible"):
        fac.plan_fn((64, 64), 3, DataParallel(m22))
    with pytest.raises(ValueError, match="no axis"):
        fac.plan_fn((64, 64), 2, GridPlan(unit, data_axis="nope"))
    with pytest.raises(ValueError, match="axes must differ"):
        fac.plan_fn((64, 64), 2, GridPlan(unit, data_axis="model"))
    with pytest.raises(ValueError, match="divisible"):
        fac.plan_fn((128, 64), 3, GridPlan(m22))
    with pytest.raises(ValueError, match="bands"):
        fac.plan_fn((128, 64), 2, GridPlan(m22, bands=4))


def test_unbanded_walk_never_yields():
    _, fac = _setup("vgg16", "optimized", "f32")
    model = fac.model(HW, "f32")
    x = torch.from_numpy(images())
    band = model.for_plane((64, 128), plane_bands=2)
    walk = band.band_walk(fac.params(HW, "f32"), x[:, :64])
    with pytest.raises(RuntimeError, match="halo exchange"):
        finish(walk)


# ---------------------------------------------------------------------------
# STDService routing against the JAX service
# ---------------------------------------------------------------------------

def _boxes(out):
    return [[(b["label"], b["box"], b["area"]) for b in r] for r in out]


@functools.lru_cache(maxsize=None)
def _weights():
    ref = JSTDService(width=0.125, buckets=(64,))
    return params_from_numpy(jax.tree_util.tree_map(
        np.asarray, ref.factory.params((64, 64), "f32", "pixellink")))


def _requests():
    rng = np.random.default_rng(7)
    return [rng.random(s).astype(np.float32)
            for s in ((100, 48, 3), (48, 100, 3), (200, 48, 3))]


def test_service_tall_plan_matches_reference():
    """Over-tall requests pad to the band unit and ride the row-banded
    tall plan; an over-wide one is transposed onto it (paper §IV.B).
    Boxes equal the JAX service's on a unit mesh."""
    jmesh = j_make_host_mesh((1, 1), ("data", "model"))
    ref = JSTDService(width=0.125, buckets=(64,), max_batch=2,
                      tall_plan=JRowBand(jmesh, axis="model"))
    port = STDService(width=0.125, buckets=(64,), max_batch=2,
                      device="cpu", params=_weights(),
                      tall_plan=RowBand(host_mesh((1, 2))))
    reqs = _requests()
    assert _boxes([port(i) for i in reqs]) == _boxes([ref(i) for i in reqs])
    assert port.stats["transposed"] == 1
    plans = {(e["hw"], e["plan"]) for e in port.factory.stats["compiled"]}
    assert plans == {((128, 64), "row_band[model=2]"),
                     ((256, 64), "row_band[model=2]")}
    assert port._tall_height(150) == port._tall_height(192) == 192


def test_service_planner_matches_reference():
    """A planner over a (1, 4) host mesh routes the over-tall and
    transposed over-wide requests to RowBand (force_banded); the JAX
    planner on its unit mesh routes them to one device.  Boxes equal;
    ``stats["plan_choices"]`` and the metrics name the choices."""
    jmesh = j_make_host_mesh((1, 1), ("data", "model"))
    ref = JSTDService(width=0.125, buckets=(64,), max_batch=2,
                      planner=JPlanner(jmesh))
    port = STDService(width=0.125, buckets=(64,), max_batch=2,
                      device="cpu", params=_weights(),
                      planner=Planner(host_mesh((1, 4))))
    reqs = _requests()
    assert _boxes([port(i) for i in reqs]) == _boxes([ref(i) for i in reqs])
    assert port.stats["plan_choices"] == {(128, 64): "row_band[model=4]",
                                          (256, 64): "row_band[model=4]"}
    assert ref.stats["plan_choices"][(128, 64)] == "single_device"
    snap = port.metrics_snapshot()
    assert snap['std_plan_choice{bucket="128x64",plan="row_band[model=4]"}'] \
        == 1.0
    # measured routing: the service's step walls reach the planner
    assert port.planner.cost.book is port.book


def test_service_data_parallel_batches_pad_to_multiple():
    """With a 2-wide data axis a batch of 1 pads to 2, and max_batch must
    be a multiple of 2; boxes equal a single-device service's."""
    reqs = np.random.default_rng(3).random((3, 64, 64, 3)).astype(
        np.float32)
    base = STDService(width=0.125, buckets=(64,), device="cpu",
                      params=_weights())
    dp = STDService(width=0.125, buckets=(64,), max_batch=2, device="cpu",
                    params=_weights(), plan=DataParallel(host_mesh((2, 1))))
    assert _boxes([dp(i) for i in reqs]) == _boxes([base(i) for i in reqs])
    assert {e["batch"] for e in dp.factory.stats["compiled"]} == {2}
    assert _boxes(dp.serve_batched(list(reqs))) == \
        _boxes([base(i) for i in reqs])
    with pytest.raises(ValueError, match="multiple"):
        STDService(width=0.125, buckets=(64,), max_batch=3, device="cpu",
                   plan=DataParallel(host_mesh((2, 1))))
    with pytest.raises(ValueError, match="multiple"):
        STDService(width=0.125, buckets=(64,), max_batch=5, device="cpu",
                   tall_plan=GridPlan(host_mesh((2, 2))))
