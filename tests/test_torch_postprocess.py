"""repro_torch's device box tail, single-image CC, f_measure and the rest of
core/bfp against the JAX package, on the same NumPy inputs.

Device rows are bit-equal to ``boxes_from_labels_batched_jax`` (int32,
including the overflow and empty cases); boxes and f_measure are equal;
``bfp_matmul_reference`` is within 1e-5 relative (wide accumulator) or
one mantissa step (narrow: f32 sum order can flip a truncation) of the
reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfp as jbfp
from repro.models.fcn import postprocess as jpp
from repro_torch.core import bfp as tbfp
from repro_torch.models.fcn import postprocess as tpp
from repro_torch.models.fcn.heads import build_head

torch.set_num_threads(2)

# the reference's functions, jitted once per shape (op-by-op dispatch
# would compile every op of every call)
j_cc = jax.jit(jpp.cc_label, static_argnums=(2, 3))
j_boxes = jax.jit(jpp.boxes_from_labels_jax, static_argnames="capacity")
j_boxes_batched = jax.jit(jpp.boxes_from_labels_batched_jax,
                          static_argnames="capacity")

# tests/test_postprocess_device.py's shape pool and map maker
SHAPES = ((8, 12), (13, 9), (16, 16), (24, 20))


def rand_maps(seed, H, W, p_link=0.5):
    rng = np.random.default_rng(seed)
    score = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    links = (rng.uniform(0.0, 1.0, (H, W, 8)) < p_link).astype(np.float32)
    return score, links


def _labels(seed, H, W):
    score, links = rand_maps(seed, H, W)
    return np.array(j_cc(jnp.asarray(score), jnp.asarray(links), 0.5,
                         0.5))


class TestDeviceRows:
    @pytest.mark.parametrize("seed", range(6))
    @pytest.mark.parametrize("si", range(len(SHAPES)))
    def test_rows_bit_equal_reference(self, seed, si):
        H, W = SHAPES[si]
        labels = np.stack([_labels(seed, H, W), _labels(seed + 100, H, W)])
        for cap in (4, 64):
            want_rows, want_n = j_boxes_batched(
                jnp.asarray(labels), capacity=cap)
            rows, n = tpp.boxes_from_labels_batched_torch(
                torch.from_numpy(labels), cap)
            assert rows.dtype == torch.int32 and n.dtype == torch.int32
            assert np.array_equal(rows.numpy(), np.asarray(want_rows))
            assert np.array_equal(n.numpy(), np.asarray(want_n))
            one, n1 = tpp.boxes_from_labels_torch(torch.from_numpy(labels[1]),
                                                  cap)
            assert np.array_equal(one.numpy(), rows[1].numpy())
            assert int(n1) == int(n[1])

    def test_overflow_count_exact(self):
        score = np.zeros((8, 8), np.float32)
        score[::3, ::3] = 1.0                    # 9 singleton components
        links = np.zeros((8, 8, 8), np.float32)
        labels = tpp.cc_label(torch.from_numpy(score),
                              torch.from_numpy(links))
        want = j_cc(jnp.asarray(score), jnp.asarray(links), 0.5, 0.5)
        assert np.array_equal(labels.numpy(), np.asarray(want))
        for cap in (4, 16):
            rows, n = tpp.boxes_from_labels_torch(labels, cap)
            wrows, wn = j_boxes(want, capacity=cap)
            assert int(n) == int(wn) == 9
            assert np.array_equal(rows.numpy(), np.asarray(wrows))
        assert tpp.boxes_from_compact(rows.numpy()) == \
            tpp.boxes_from_labels(labels.numpy())

    def test_empty_plane(self):
        rows, n = tpp.boxes_from_labels_torch(
            torch.zeros((8, 8), dtype=torch.int32), 4)
        wrows, wn = j_boxes(jnp.zeros((8, 8), jnp.int32), capacity=4)
        assert int(n) == int(wn) == 0
        assert np.array_equal(rows.numpy(), np.asarray(wrows))
        assert (rows == 0).all()
        assert tpp.boxes_from_compact(rows.numpy()) == []

    def test_no_background_and_arbitrary_values(self):
        """A plane with no zero (slot 0 holds a real label) and label
        values that are not representatives."""
        labels = np.arange(1, 7 * 5 + 1, dtype=np.int32).reshape(7, 5) % 6 + 3
        for cap in (2, 8):
            wrows, wn = j_boxes(jnp.asarray(labels), capacity=cap)
            rows, n = tpp.boxes_from_labels_torch(torch.from_numpy(labels),
                                                  cap)
            assert np.array_equal(rows.numpy(), np.asarray(wrows))
            assert int(n) == int(wn)


class TestCompactAndHost:
    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("min_area", [1, 3])
    def test_compact_equals_host(self, seed, min_area):
        H, W = SHAPES[seed % len(SHAPES)]
        labels = _labels(seed, H, W)
        rows, n = tpp.boxes_from_labels_torch(torch.from_numpy(labels), 64)
        host = tpp.boxes_from_labels(labels, min_area)
        assert tpp.boxes_from_compact(rows.numpy(), min_area) == host
        assert host == jpp.boxes_from_compact(np.asarray(
            j_boxes(jnp.asarray(labels), 64)[0]), min_area)
        assert int(n) == len(tpp.boxes_from_labels(labels))

    @pytest.mark.parametrize("seed", range(3))
    def test_single_image_cc_label(self, seed):
        H, W = SHAPES[seed]
        score, links = rand_maps(seed, H, W, 0.6)
        got = tpp.cc_label(torch.from_numpy(score), torch.from_numpy(links),
                           0.55, 0.45)
        want = j_cc(jnp.asarray(score), jnp.asarray(links), 0.55, 0.45)
        assert np.array_equal(got.numpy(), np.asarray(want))

    def test_head_decode_dispatches_on_payload(self):
        head = build_head("pixellink")
        labels = _labels(1, 16, 16)
        rows, n = tpp.boxes_from_labels_torch(torch.from_numpy(labels), 64)
        dev, kind_d = head.decode((rows.numpy(), int(n)), (64, 64))
        host, kind_h = head.decode(labels, (64, 64))
        assert (kind_d, kind_h) == ("device", "host") and dev == host
        assert head.payload_plane(labels) == (16, 16)
        assert head.payload_plane((rows.numpy(), int(n))) is None
        assert head.supports_device_postprocess and head.n_payload == 1


class TestFMeasure:
    def test_perfect_match(self):
        preds = [{"label": 1, "box": (0, 0, 9, 9), "area": 100}]
        assert tpp.f_measure(preds, [(0, 0, 9, 9)]) == \
            jpp.f_measure(preds, [(0, 0, 9, 9)])

    def test_best_iou_not_first_past_threshold(self):
        gts = [(0, 0, 9, 9), (5, 0, 14, 9)]
        preds = [{"label": 1, "box": (3, 0, 12, 9), "area": 100},
                 {"label": 2, "box": (0, 0, 9, 9), "area": 100}]
        m = tpp.f_measure(preds, gts)
        assert m == jpp.f_measure(preds, gts)
        assert m["precision"] == 1.0 and m["recall"] == 1.0

    @pytest.mark.parametrize("seed", range(3))
    def test_random_boxes(self, seed):
        rng = np.random.default_rng(seed)

        def box():
            x0, y0 = rng.integers(0, 20, 2)
            return (int(x0), int(y0), int(x0 + rng.integers(0, 10)),
                    int(y0 + rng.integers(0, 10)))

        preds = [{"label": i, "box": box(), "area": 1} for i in range(8)]
        gts = [box() for _ in range(6)]
        for thr in (0.3, 0.5):
            assert tpp.f_measure(preds, gts, thr) == \
                jpp.f_measure(preds, gts, thr)


class TestBFP:
    def test_wide_accumulator_matches_reference(self):
        a = np.array(jax.random.normal(jax.random.PRNGKey(0), (32, 128)))
        b = np.array(jax.random.normal(jax.random.PRNGKey(1), (128, 16)))
        want = np.asarray(jbfp.bfp_matmul_reference(
            jnp.asarray(a), jnp.asarray(b), mantissa_bits=12))
        got = tbfp.bfp_matmul_reference(torch.from_numpy(a),
                                        torch.from_numpy(b),
                                        mantissa_bits=12).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        rel = np.abs(got - a @ b).max() / np.abs(a @ b).max()
        assert rel < 2e-3

    def test_narrow_accumulator_matches_reference(self):
        mb = 6
        a = np.array(jax.random.normal(jax.random.PRNGKey(2), (16, 512))) * 3
        b = np.array(jax.random.normal(jax.random.PRNGKey(3), (512, 16)))
        ref = a @ b
        out = {}
        for wide in (True, False):
            want = np.asarray(jbfp.bfp_matmul_reference(
                jnp.asarray(a), jnp.asarray(b), mantissa_bits=mb,
                wide_accum=wide))
            got = tbfp.bfp_matmul_reference(
                torch.from_numpy(a), torch.from_numpy(b), mantissa_bits=mb,
                wide_accum=wide).numpy()
            # one mantissa step of the row's block (the narrow sums are
            # truncated to mb bits against the row maximum)
            step = 2.0 ** -mb * np.abs(want).max(axis=1, keepdims=True)
            tol = step if not wide else 1e-5 * np.abs(want).max()
            assert (np.abs(got - want) <= tol).all()
            out[wide] = (np.mean(np.abs(got - ref)),
                         np.mean(np.abs(want - ref)))
        (port_w, ref_w), (port_n, ref_n) = out[True], out[False]
        assert port_n > port_w and ref_n > ref_w

    @pytest.mark.parametrize("mb", [4, 7, 10])
    def test_quantization_error_equal(self, mb):
        x = np.random.default_rng(mb).standard_normal((64, 96)).astype(
            np.float32) * 10
        got = float(tbfp.quantization_error(torch.from_numpy(x),
                                            mantissa_bits=mb))
        want = float(jbfp.quantization_error(jnp.asarray(x),
                                             mantissa_bits=mb))
        assert got == pytest.approx(want, rel=1e-6)

    @pytest.mark.parametrize("mb", [7, 10, 15, 20])
    def test_nbytes_model_equal(self, mb):
        x = np.ones((128, 256), np.float32)
        got = tbfp.quantize(torch.from_numpy(x), block_size=32,
                            mantissa_bits=mb)
        want = jbfp.quantize(jnp.asarray(x), block_size=32, mantissa_bits=mb)
        assert got.nbytes_model() == want.nbytes_model()
        assert tuple(got.shape) == tuple(want.shape)
