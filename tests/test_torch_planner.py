"""repro_torch's cost-model planner and its inputs against the JAX
package's: the golden routing table, the step-cost and eligibility
properties, program features and band costs on the golden programs,
``conv2d_banded``, the halo exchange, the mesh and activation specs,
and the calibration fit with its JSON files.

The golden table is the reference's own (``tests/test_planner.py``),
recomputed here by both packages' ``choose_kind`` at the reference's
``TEST_PARAMS``.  Features and band costs are pure shape walks, so they
are compared exactly; the calibration fit solves the same least-squares
problem in NumPy, held to 1e-9 relative.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_planner as ref_tests
from repro.core import rowband as jrowband
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.models.fcn import DetectionModel as JDetectionModel
from repro.models.fcn import build_head as j_build_head
from repro.models.fcn.pixellink import STDConfig as JSTDConfig
from repro.runtime import planner as jplanner
from repro.runtime import telemetry as jtel
from repro_torch.core import rowband
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_mesh
from repro_torch.models.fcn import DetectionModel, STDConfig, build_head
from repro_torch.runtime import planner, telemetry
from repro_torch.runtime.collectives import halo_bounds, halo_exchange
from repro_torch.runtime.executor import (DEFAULT_MODEL, DataParallel,
                                          GridPlan, RowBand, SingleDevice)
from repro_torch.runtime.sharding import (fcn_activation_specs,
                                          fcn_batch_axis, split_dims)

torch.set_num_threads(2)

TEST_PARAMS = planner.CostParams(**dataclasses.asdict(ref_tests.TEST_PARAMS))
J_TEST_PARAMS = ref_tests.TEST_PARAMS


def tall_features(h, w=64):
    return planner.PlanFeatures(**dataclasses.asdict(
        ref_tests.tall_features(h, w)))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

GOLDEN = ref_tests.TestGoldenRouting.GOLDEN


@pytest.mark.parametrize("row", sorted(GOLDEN, key=repr), ids=repr)
def test_golden_routing_row(row):
    hw, batch, (dn, mn) = row
    got = planner.choose_kind(tall_features(*hw), hw, batch, data_n=dn,
                              model_n=mn, params=TEST_PARAMS)
    want = jplanner.choose_kind(ref_tests.tall_features(*hw), hw, batch,
                                data_n=dn, model_n=mn, params=J_TEST_PARAMS)
    assert got == want == GOLDEN[row]


def test_step_costs_equal_reference():
    """Every kind's analytic cost on the golden grid, and on features with
    an activation footprint, equals the reference's to the last bit."""
    for hw, batch, (dn, mn) in GOLDEN:
        for kind in planner.PLAN_KINDS:
            for act in (0.0, 3e6):
                f = dataclasses.replace(tall_features(*hw), act_bytes=act)
                jf = dataclasses.replace(ref_tests.tall_features(*hw),
                                         act_bytes=act)
                assert planner.step_cost(
                    f, kind, batch, data_n=dn, model_n=mn,
                    params=TEST_PARAMS) == jplanner.step_cost(
                    jf, kind, batch, data_n=dn, model_n=mn,
                    params=J_TEST_PARAMS)


class TestStepCost:
    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError, match="unknown plan kind"):
            planner.step_cost(tall_features(64), "pod", 1)

    def test_occupancy_batch_one_never_prefers_data_parallel(self):
        f = tall_features(64)
        for dn in (2, 4, 8):
            dp = planner.step_cost(f, "data_parallel", 1, data_n=dn,
                                   params=TEST_PARAMS)
            sd = planner.step_cost(f, "single_device", 1,
                                   params=TEST_PARAMS)
            assert dp > sd

    def test_data_parallel_wins_at_full_batch(self):
        f = tall_features(256)
        dp = planner.step_cost(f, "data_parallel", 8, data_n=4,
                               params=TEST_PARAMS)
        sd = planner.step_cost(f, "single_device", 8, params=TEST_PARAMS)
        assert dp < sd

    def test_grid_splits_both_axes(self):
        f = tall_features(1024)
        kw = dict(data_n=2, model_n=4, params=TEST_PARAMS)
        grid = planner.step_cost(f, "grid", 8, **kw)
        assert grid < planner.step_cost(f, "row_band", 8, **kw)
        assert grid < planner.step_cost(f, "data_parallel", 8, **kw)

    def test_halo_layer_launches_penalize_banded_plans_only(self):
        base = tall_features(512)
        many = dataclasses.replace(base, halo_layers=30)
        kw = dict(data_n=2, model_n=4, params=TEST_PARAMS)
        for kind in ("single_device", "data_parallel"):
            assert planner.step_cost(many, kind, 4, **kw) == \
                planner.step_cost(base, kind, 4, **kw)
        for kind in ("row_band", "grid"):
            assert planner.step_cost(many, kind, 4, **kw) == \
                pytest.approx(planner.step_cost(base, kind, 4, **kw)
                              + 30 * TEST_PARAMS.halo_launch_s)

    def test_padded_batch(self):
        assert [planner.padded_batch(b, 4) for b in (1, 4, 5, 8)] == \
            [4, 4, 8, 8]


class TestEligibility:
    def test_band_height_invariant_gates_banded_kinds(self):
        kw = dict(data_n=2, model_n=4, deepest_stride=32)
        assert "row_band" in planner.eligible_kinds((128, 64), **kw)
        assert "grid" in planner.eligible_kinds((128, 64), **kw)
        assert "row_band" not in planner.eligible_kinds((96, 64), **kw)
        assert "grid" not in planner.eligible_kinds((96, 64), **kw)

    def test_unit_mesh_is_single_device_only(self):
        assert planner.eligible_kinds((2048, 64), data_n=1, model_n=1,
                                      deepest_stride=32) == ["single_device"]

    def test_no_data_axis_no_batch_kinds(self):
        kinds = planner.eligible_kinds((256, 64), data_n=1, model_n=4,
                                       deepest_stride=32)
        assert kinds == ["single_device", "row_band"]

    @pytest.mark.parametrize("dn,mn", [(1, 1), (4, 1), (1, 4), (2, 4)])
    def test_equal_reference(self, dn, mn):
        for h in (64, 96, 128, 256, 512):
            assert planner.eligible_kinds(
                (h, 64), data_n=dn, model_n=mn, deepest_stride=32) == \
                jplanner.eligible_kinds((h, 64), data_n=dn, model_n=mn,
                                        deepest_stride=32)


class TestRouting:
    def test_taller_never_moves_back_to_single_device(self):
        kw = dict(data_n=2, model_n=4, params=TEST_PARAMS)
        for batch in (1, 4, 8):
            seen_banded = False
            for h in (128, 256, 512, 1024, 2048):
                kind = planner.choose_kind(tall_features(h), (h, 64), batch,
                                           **kw)
                if kind in ("row_band", "grid"):
                    seen_banded = True
                elif seen_banded:
                    raise AssertionError(f"h={h} batch={batch} -> {kind}")

    def test_force_banded_lands_on_row_banded_plan(self):
        for dn in (1, 2):
            kind = planner.choose_kind(
                tall_features(64), (128, 64), 1, data_n=dn, model_n=4,
                params=TEST_PARAMS, force_banded=True)
            assert kind in ("row_band", "grid")

    def test_force_banded_falls_back_without_capacity(self):
        assert planner.choose_kind(
            tall_features(2048), (2048, 64), 1, data_n=4, model_n=1,
            params=TEST_PARAMS, force_banded=True) == "single_device"

    def test_cost_and_params_together_rejected(self):
        with pytest.raises(ValueError, match="not both"):
            planner.choose_kind(tall_features(64), (64, 64), 1, data_n=1,
                                model_n=1, params=TEST_PARAMS,
                                cost=planner.AnalyticCost())


def test_default_params_carry_the_h100_rates():
    """The defaults are the H100 datasheet's, not the TPU's: 35% of
    989 TFLOP/s, NVLink's 900 GB/s, HBM3's 3.35 TB/s."""
    p = planner.CostParams()
    assert p.peak_flops == pytest.approx(0.35 * 989e12)
    assert p.ici_bw == 900e9 and p.hbm_bw == 3.35e12
    assert {f.name for f in dataclasses.fields(p)} == \
        {f.name for f in dataclasses.fields(jplanner.CostParams)}


# ---------------------------------------------------------------------------
# program features on the golden programs
# ---------------------------------------------------------------------------

PROGRAMS = [("pixellink", "vgg16"), ("pixellink", "resnet50"),
            ("east", "vgg16"), ("db", "vgg16")]


def _programs(head, backbone, hw=(64, 64)):
    kw = dict(name=f"{head}_{backbone}", backbone=backbone, width=0.125,
              image_size=hw, merge_ch=(16, 16, 8), mode="reference",
              storage_fp16=False)
    ref = JDetectionModel(JSTDConfig(**kw), j_build_head(head))
    port = DetectionModel(STDConfig(**kw), build_head(head), device="cpu")
    return ref.program, port.program


@pytest.mark.parametrize("head,backbone", PROGRAMS)
@pytest.mark.parametrize("hw", [(64, 64), (128, 64)])
def test_band_costs_and_features_equal_reference(head, backbone, hw):
    jprog, prog = _programs(head, backbone, hw)
    for mode in ("reference", "optimized"):
        for dtype_bytes in (2, 4):
            assert rowband.program_band_costs(
                prog, dtype_bytes=dtype_bytes, mode=mode) == \
                jrowband.program_band_costs(
                    jprog, dtype_bytes=dtype_bytes, mode=mode)
        got = planner.features_for_program(prog, 32, mode=mode)
        want = jplanner.features_for_program(jprog, 32, mode=mode)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert rowband.program_halo_rows(prog) == \
        jrowband.program_halo_rows(jprog)
    c = rowband.program_band_costs(prog)
    assert c["flops"] > 0 and c["halo_bytes"] > 0 and c["halo_layers"] > 0


def test_flops_scale_with_height_halo_does_not():
    c1 = rowband.program_band_costs(_programs("pixellink", "vgg16")[1])
    c2 = rowband.program_band_costs(
        _programs("pixellink", "vgg16", (128, 64))[1])
    assert c2["flops"] == pytest.approx(2 * c1["flops"], rel=0.05)
    assert c2["halo_bytes"] == c1["halo_bytes"]


@pytest.mark.parametrize("k,s,halo", [(1, 1, 0), (2, 2, 0), (3, 1, 4),
                                      (3, 2, 4), (7, 2, 8), (1, 2, 0)])
def test_layer_halo(k, s, halo):
    """ResNet-50's 7x7/2 stem takes 8 rows, 3x3 convs and the 3x3/2
    max-pool 4, 1x1 and 2x2/2 layers none."""
    assert rowband.layer_halo(k, s) == halo


# ---------------------------------------------------------------------------
# conv2d_banded, band schedule
# ---------------------------------------------------------------------------

def _sym_conv(x, w, stride):
    pad = (w.shape[0] - 1) // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("seed", range(6))
def test_conv2d_banded_equals_full_conv(seed):
    rng = np.random.default_rng(seed)
    h = int(rng.integers(6, 41))
    k = int(rng.choice([1, 3, 7]))
    stride = int(rng.choice([1, 2]))
    n_bands = int(rng.integers(1, 7))
    x = rng.standard_normal((2, h, 11, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    got = rowband.conv2d_banded(torch.from_numpy(x), torch.from_numpy(w),
                                stride=stride, n_bands=n_bands)
    want = _sym_conv(torch.from_numpy(x), torch.from_numpy(w), stride)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    ref = jrowband.conv2d_banded(x, w, stride=stride, n_bands=n_bands)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_band_schedule_and_bytes_equal_reference():
    for buf in (1 << 20, 8 << 20):
        assert rowband.band_schedule(512, 512, 64, buffer_bytes=buf) == \
            jrowband.band_schedule(512, 512, 64, buffer_bytes=buf)
    assert len(rowband.band_schedule(512, 512, 64, buffer_bytes=1 << 20)) \
        > len(rowband.band_schedule(512, 512, 64, buffer_bytes=8 << 20))
    for args in ((0, 16, 64, 32, 3, 1), (8, 24, 64, 32, 7, 2)):
        assert rowband.bytes_per_round(*args) == \
            jrowband.bytes_per_round(*args)


# ---------------------------------------------------------------------------
# halo exchange, mesh, specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("halo", [0, 1, 2, 3, 5])
def test_halo_exchange_rows(halo):
    """Two images of 8 rows in 4 bands of 2: the narrow (halo 1), band-equal
    (2) and wide (3, 5: rows from several neighbours) cases equal each
    image's own zero-padded plane sliced per band (the reference's
    ``TestHaloExchange2D`` construction); images never mix."""
    x = np.arange(2 * 8, dtype=np.float32).reshape(2, 8, 1, 1)
    x[1] += 100.0
    bands = [torch.from_numpy(x[:, 2 * i:2 * i + 2]) for i in range(4)]
    got = halo_exchange(bands, halo)
    padded = np.pad(x, ((0, 0), (halo, halo), (0, 0), (0, 0)))
    for i, g in enumerate(got):
        np.testing.assert_array_equal(
            g.numpy(), padded[:, 2 * i:2 * i + 2 + 2 * halo])


@pytest.mark.parametrize("band,halo", [(1, 4), (2, 4), (3, 4), (4, 4),
                                       (6, 8)])
def test_halo_exchange_aligned_to_tiles(band, halo):
    """With ``align=4`` each band's extension starts and ends at plane rows
    that are multiples of 4, covers at least ``halo`` rows on each side,
    and holds exactly those rows of the zero-padded plane; the starts
    ``drive_bands`` hands back put the band's own rows where they are."""
    n = 4
    x = torch.arange(2 * n * band, dtype=torch.float32).reshape(
        2, n * band, 1, 1)
    bands = list(x.split(band, dim=1))
    got = halo_exchange(bands, halo, align=4)
    pad = 16
    padded = torch.nn.functional.pad(x, (0, 0, 0, 0, pad, pad))
    for i, (g, (lo, hi)) in enumerate(zip(got, halo_bounds(n, band, halo,
                                                           4))):
        assert lo % 4 == 0 and hi % 4 == 0
        assert lo <= i * band - halo and hi >= (i + 1) * band + halo
        assert torch.equal(g, padded[:, lo + pad:hi + pad])
        j = i * band - lo
        assert torch.equal(g[:, j:j + band], bands[i])


@pytest.mark.parametrize("bands", [2, 4])
def test_fused_upsample_band_rows_bit_equal(bands):
    """The fused upsample on a band extended by its 4-row halo gives the
    band's rows of the full plane's output bit for bit: its tap products
    run as GEMMs of one fixed shape, whatever the plane's height (here
    3,072 pixels, two GEMMs, against a band's one)."""
    from repro_torch.core import fuse

    rng = np.random.default_rng(bands)
    x = torch.from_numpy(rng.standard_normal((1, 48, 64, 8), np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 8, 5), np.float32))
    full = fuse.upsample2x_conv3x3_fused(x, w)
    bh = 48 // bands
    for i, xb in enumerate(halo_exchange(list(x.split(bh, dim=1)), 4)):
        got = fuse.upsample2x_conv3x3_fused(xb, w)[:, 8:8 + 2 * bh]
        assert torch.equal(got, full[:, 2 * i * bh:2 * (i + 1) * bh]), i


def test_halo_exchange_keeps_storage_dtype():
    bands = [torch.ones((1, 2, 3, 4), dtype=torch.float16)] * 2
    out = halo_exchange(bands, 4)
    assert all(t.dtype == torch.float16 and t.shape == (1, 10, 3, 4)
               for t in out)
    with pytest.raises(ValueError, match="differ"):
        halo_exchange([torch.ones((1, 2, 1, 1)), torch.ones((1, 3, 1, 1))],
                      1)


def test_host_mesh():
    m = make_host_mesh((2, 4), ("data", "model"), device="cpu")
    assert m.axis_sizes() == {"data": 2, "model": 4}
    assert m.device_at(data=1, model=3) == torch.device("cpu")
    assert m == make_host_mesh((2, 4), ("data", "model"), device="cpu")
    assert hash(m) == hash(make_host_mesh((2, 4), device="cpu"))
    assert m != make_host_mesh((4, 2), device="cpu")
    assert RowBand(m) == RowBand(make_host_mesh((2, 4), device="cpu"))
    with pytest.raises(ValueError, match="no axes"):
        m.device_at(pod=0)
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.empty((2, 2), dtype=object), ("data",))


def test_make_mesh_raises_without_enough_cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh((1, n + 1), ("data", "model"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_host_mesh((1, 2), device="cuda:0")


def test_fcn_activation_specs_equal_reference():
    """The reference's PartitionSpecs and the port's per-dim axes state the
    same facts, for data-parallel, row-band and grid layouts."""
    from repro.runtime.sharding import fcn_activation_specs as jspecs

    for b, r in ((None, None), ("data", None), (None, "model"),
                 ("data", "model")):
        got, want = fcn_activation_specs(b, r), jspecs(b, r)
        assert set(got) == set(want)
        for k in got:
            assert got[k] == tuple(want[k]) + (None,) * (
                len(got[k]) - len(tuple(want[k])))
    g = fcn_activation_specs("data", "model")
    assert split_dims(g["image"], "data") == (0,)
    assert split_dims(g["image"], "model") == (1,)


def test_fcn_batch_axis():
    m = make_host_mesh((4, 2), ("data", "model"), device="cpu")
    assert fcn_batch_axis(m, 8) == "data"
    assert fcn_batch_axis(m, 6) is None
    assert fcn_batch_axis(make_host_mesh((1, 1), device="cpu"), 8) is None


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

@pytest.fixture()
def unit_mesh():
    return make_host_mesh((1, 1), ("data", "model"), device="cpu")


class TestPlanner:
    def test_features_memoized(self, unit_mesh):
        calls = []

        def feats(hw):
            calls.append(hw)
            return tall_features(hw[0], hw[1])

        p = planner.Planner(unit_mesh, feats)
        p.choose((64, 64), 1)
        p.choose((64, 64), 4)
        assert calls == [(64, 64)]

    def test_unbound_features_raise(self, unit_mesh):
        with pytest.raises(RuntimeError, match="features_fn"):
            planner.Planner(unit_mesh).choose((64, 64), 1)

    def test_bind_features_is_idempotent(self, unit_mesh):
        first = lambda hw: tall_features(hw[0], hw[1])
        p = planner.Planner(unit_mesh, first)
        p.bind_features(lambda hw: (_ for _ in ()).throw(AssertionError))
        assert p._features_fns[DEFAULT_MODEL] is first
        other = lambda hw: tall_features(hw[0], hw[1])
        p.bind_features(other, model="east")
        p.bind_features(lambda hw: (_ for _ in ()).throw(AssertionError),
                        model="east")
        assert p._features_fns["east"] is other

    def test_plan_for_kind_mapping(self):
        m = make_host_mesh((2, 4), device="cpu")
        p = planner.Planner(m)
        assert p.plan_for_kind("single_device") == SingleDevice()
        assert p.plan_for_kind("data_parallel") == DataParallel(m, "data")
        assert p.plan_for_kind("row_band") == RowBand(m, axis="model")
        assert p.plan_for_kind("grid") == GridPlan(m)
        assert (p.data_n, p.model_n) == (2, 4)
        with pytest.raises(ValueError, match="unknown plan kind"):
            p.plan_for_kind("pod")

    def test_height_unit(self, unit_mesh):
        assert planner.Planner(unit_mesh).height_unit(32) == 32
        assert planner.Planner(make_host_mesh(
            (1, 4), device="cpu")).height_unit(32) == 128

    def test_costs_table_only_eligible_kinds(self, unit_mesh):
        p = planner.Planner(unit_mesh, lambda hw: tall_features(*hw))
        assert set(p.costs((256, 64), 4)) == {"single_device"}

    def test_costs_equal_reference(self):
        feats = lambda hw: tall_features(*hw)
        jfeats = lambda hw: ref_tests.tall_features(*hw)
        p = planner.Planner(make_host_mesh((2, 4), device="cpu"), feats,
                            params=TEST_PARAMS)
        jmesh = j_make_host_mesh((1, 1), ("data", "model"))
        jp = jplanner.Planner(jmesh, jfeats, params=J_TEST_PARAMS)
        jp.data_n, jp.model_n = 2, 4
        for hw, batch in (((128, 64), 1), ((512, 64), 4), ((64, 64), 8)):
            assert p.costs(hw, batch) == jp.costs(hw, batch)

    def test_measured_overlay_and_set_params(self, unit_mesh):
        """Measured EWMAs override the analytic cost after enough
        observations; set_params swaps the constants under the overlay."""
        book = telemetry.CostBook(warmup=0)
        p = planner.Planner(make_host_mesh((1, 4), device="cpu"),
                            lambda hw: tall_features(*hw),
                            params=TEST_PARAMS)
        p.use_measurements(book, min_observations=2)
        assert isinstance(p.cost, planner.MeasuredCost)
        assert p.choose((256, 64), 1).__class__ is RowBand
        for _ in range(2):
            book.record_step((256, 64), 1, "row_band", 5.0)
        assert p.choose((256, 64), 1) == SingleDevice()
        p.set_params(planner.CostParams())
        assert isinstance(p.cost, planner.MeasuredCost)
        assert p.params == planner.CostParams()
        assert p.use_measurements(book, min_observations=2) is p


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def _measurements(mod):
    rng = np.random.default_rng(0)
    rows = []
    for kind, (dn, mn) in (("single_device", (1, 1)),
                           ("data_parallel", (2, 1)),
                           ("row_band", (1, 4)), ("grid", (2, 4))):
        for batch in (1, 2, 4, 8):
            flops = float(rng.uniform(1e9, 1e11))
            halo = float(rng.uniform(1e4, 1e6))
            layers = int(rng.integers(10, 40))
            secs = float(rng.uniform(1e-3, 5e-2))
            rows.append(mod.StepMeasurement(flops, halo, layers, kind, batch,
                                            dn, mn, secs))
    return rows


def test_fit_cost_params_equals_reference():
    """Same rows, same base for the columns the fit leaves alone (the two
    packages' defaults differ: H100 against TPU rates)."""
    got = telemetry.fit_cost_params(_measurements(telemetry),
                                    base=TEST_PARAMS)
    want = jtel.fit_cost_params(_measurements(jtel), base=J_TEST_PARAMS)
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert set(g) == set(w)
    # hbm_bw is not a fitted column: each package keeps its default
    assert g.pop("hbm_bw") == planner.CostParams().hbm_bw
    w.pop("hbm_bw")
    for k in g:
        assert g[k] == pytest.approx(w[k], rel=1e-9), k


def test_fit_keeps_unidentifiable_columns():
    rows = [telemetry.StepMeasurement(1e9 * b, 1e5, 20, "single_device",
                                      b, 1, 1, 1e-3 + 1e-4 * b)
            for b in (1, 2, 4)]
    base = planner.CostParams()
    fit = telemetry.fit_cost_params(rows, base=base)
    assert fit.ici_bw == base.ici_bw
    assert fit.halo_launch_s == base.halo_launch_s
    assert telemetry.fit_cost_params([], base=base) is base
    with pytest.raises(ValueError, match="unknown plan kind"):
        telemetry.fit_cost_params([dataclasses.replace(rows[0],
                                                       kind="pod")])


def test_cost_params_json_both_ways(tmp_path):
    """A file saved by either package loads in the other, exactly."""
    params = telemetry.fit_cost_params(_measurements(telemetry))
    jparams = jtel.fit_cost_params(_measurements(jtel))
    mine, theirs = tmp_path / "port.json", tmp_path / "ref.json"
    telemetry.save_cost_params(params, str(mine),
                               measurements=_measurements(telemetry),
                               meta={"device": "cpu"})
    jtel.save_cost_params(jparams, str(theirs),
                          measurements=_measurements(jtel))
    assert jtel.load_cost_params(str(mine)) == \
        jplanner.CostParams(**dataclasses.asdict(params))
    assert telemetry.load_cost_params(str(theirs)) == \
        planner.CostParams(**dataclasses.asdict(jparams))
    doc = json.loads(mine.read_text())
    assert len(doc["measurements"]) == 16 and doc["meta"] == {
        "device": "cpu"}
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"peak_flops": 1e12}))
    assert telemetry.load_cost_params(str(bare)).peak_flops == 1e12
    with pytest.raises(ValueError, match="unknown CostParams"):
        telemetry.cost_params_from_dict({"nope": 1.0})
