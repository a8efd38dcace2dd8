"""The model zoo in repro_torch against the JAX package: the PixelLink,
EAST and DB heads compile through one assembler -> microcode -> FCNEngine
seam, their disassemblies equal the golden snapshots byte for byte, the
engine LRU keys on the model, every head's serving decode equals its
NumPy ``reference_decode`` and the JAX head's decode on one shared set of
maps, and ``STDService(model="east" | "db")`` serves boxes equal to the
JAX service's.

The golden build is the reference's (tests/test_model_zoo.py): a
width-0.125 VGG-16 trunk at 64x64 in reference mode.  The snapshots are
only read here."""
import os

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # pragma: no cover - bare interpreter
    from _hypothesis_compat import given, settings, strategies as st

import jax
import numpy as np
import pytest
import torch

from repro.core.memplan import plan_disassembly as j_plan_disassembly
from repro.launch.serve import STDService as JSTDService
from repro.models.fcn import DetectionModel as JDetectionModel
from repro.models.fcn import build_head as j_build_head
from repro.models.fcn.heads import db_unclip_box as j_db_unclip_box
from repro.models.fcn.pixellink import STDConfig as JSTDConfig
from repro_torch.core.memplan import plan_disassembly
from repro_torch.core.microcode import ExtOp
from repro_torch.data.images import RequestStream
from repro_torch.launch.serve import STDService
from repro_torch.models.fcn import (
    DEFAULT_MODEL, MODEL_ZOO, DetectionModel, STDConfig, build_head,
    check_model, db_unclip_box, params_from_numpy)
from repro_torch.runtime.executor import EngineFactory, SingleDevice

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_HW = (64, 64)
NAMES = ("db", "east", "pixellink")
ARITY = {"pixellink": 2, "db": 2, "east": 3}


def _cfg(cls, name, hw=GOLDEN_HW, **kw):
    base = dict(name=f"{name}_vgg16", backbone="vgg16", width=0.125,
                image_size=tuple(hw), merge_ch=(16, 16, 8),
                mode="reference", storage_fp16=False)
    base.update(kw)
    return cls(**base)


def golden_model(name: str, hw=GOLDEN_HW) -> DetectionModel:
    return DetectionModel(_cfg(STDConfig, name, hw), build_head(name),
                          device="cpu")


def j_golden_model(name: str, hw=GOLDEN_HW) -> JDetectionModel:
    return JDetectionModel(_cfg(JSTDConfig, name, hw), j_build_head(name))


def _factory() -> EngineFactory:
    return EngineFactory(
        lambda hw, precision="f32", model=DEFAULT_MODEL:
            golden_model(model, hw), device="cpu")


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("name", NAMES)
def test_head_compiles_and_applies(name):
    """Each head assembles to the reference's microcode bytes and apply()
    returns the maps it declares, at the declared ranks."""
    m = golden_model(name)
    assert m.head.maps == j_build_head(name).maps
    raw = m.microcode_bytes()
    assert raw.size == 32 * len(m.program.words)
    assert np.array_equal(raw, np.asarray(j_golden_model(name)
                                          .microcode_bytes()))
    params = m.init_params(torch.Generator().manual_seed(0))
    x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    out = m.apply(params, x)
    for map_name, rank in m.head.maps:
        assert out[map_name].ndim == rank
        assert tuple(out[map_name].shape[1:3]) == (16, 16)


def test_db_residual_head_uses_add_ext_op():
    """DB's shortcut lowers to the binary ADD ext op, whose in_ch is one
    operand's channels, not their sum."""
    adds = [w for w in golden_model("db").program.words
            if w.ext_opcode == ExtOp.ADD]
    assert adds
    assert adds[-1].in_ch == adds[-1].out_ch


def test_check_model_and_build_head_options():
    with pytest.raises(ValueError, match="unknown model"):
        check_model("craft")
    assert sorted(MODEL_ZOO) == sorted(NAMES)
    east = build_head("east", geo_scale=4.0, nms_iou=0.3)
    db = build_head("db", unclip_ratio=2.0, head_ch=8)
    assert (east.geo_scale, east.nms_iou) == (4.0, 0.3)
    assert (db.unclip_ratio, db.head_ch) == (2.0, 8)


@pytest.mark.parametrize("name", NAMES)
def test_disassembly_matches_golden(name):
    text = golden_model(name).program.disassemble() + "\n"
    assert text == _read(os.path.join(GOLDEN_DIR, f"microcode_{name}.txt"))


@pytest.mark.parametrize("name", NAMES)
def test_memplan_disassembly_matches_golden(name):
    text = plan_disassembly(golden_model(name).program) + "\n"
    assert text == _read(os.path.join(GOLDEN_DIR,
                                      f"microcode_{name}_memplan.txt"))
    assert text == j_plan_disassembly(j_golden_model(name).program) + "\n"


def test_engine_lru_keys_per_model():
    """One (bucket, batch, plan, precision) and three models: three models,
    three parameter sets and three engines, each returning its head's
    payload arity; the compiled record names the model."""
    fac = _factory()
    models = {n: fac.model(GOLDEN_HW, "f32", n) for n in NAMES}
    assert len({id(m) for m in models.values()}) == 3
    for n, m in models.items():
        assert m.head.name == n and fac.model(GOLDEN_HW, "f32", n) is m
    assert len({id(fac.params(GOLDEN_HW, "f32", n)) for n in NAMES}) == 3
    fns = {n: fac.plan_fn(GOLDEN_HW, 1, SingleDevice(), "f32", n)
           for n in NAMES}
    assert len({id(f) for f in fns.values()}) == 3
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(1, *GOLDEN_HW, 3)).astype(np.float32))
    vq = torch.tensor([[16, 16]], dtype=torch.int32)
    out = {n: fn(fac.params(GOLDEN_HW, "f32", n), x, vq)
           for n, fn in fns.items()}
    for n in NAMES:
        assert len(out[n]) == ARITY[n] == MODEL_ZOO[n].n_payload + 1
        assert [t.ndim for t in out[n][:-1]] == \
            list(MODEL_ZOO[n].payload_ranks)
    assert tuple(out["east"][1].shape) == (1, 16, 16, 4)
    assert [e["model"] for e in fac.stats["compiled"]] == list(NAMES)
    with pytest.raises(ValueError, match="unknown model"):
        fac.plan_fn(GOLDEN_HW, 1, SingleDevice(), "f32", "craft")


@pytest.fixture(scope="module")
def shared_maps():
    """Per head: the port's maps of one image under seeded weights, each
    score map shifted so that a quarter of the valid pixels pass the
    threshold (random weights alone leave EAST with no candidate box)."""
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        size=(1, 64, 64, 3)).astype(np.float32))
    out = {}
    for name in NAMES:
        m = golden_model(name)
        maps = m.apply(m.init_params(torch.Generator().manual_seed(3)), x)
        s = maps["score"]
        maps["score"] = (s - s[:, :, :14].quantile(0.75) + 0.5).clamp(0, 1)
        out[name] = maps
    return out


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_reference_and_jax(name, shared_maps):
    """On one shared set of maps at the ragged valid plane (64, 56): the
    port's tail payload is bit-equal to the JAX tail's, and the port's
    serving decode equals its ``reference_decode`` and the JAX head's
    decode of the same payload, box for box."""
    import jax.numpy as jnp
    from repro.runtime.executor import EngineFactory as JEngineFactory

    maps = shared_maps[name]
    head, jhead = build_head(name), j_build_head(name)
    valid = (64, 56)
    vq = [[valid[0] // 4, valid[1] // 4]]
    tail = head.tail(_factory(), maps, torch.tensor(vq, dtype=torch.int32))
    jtail = jhead.tail(JEngineFactory(lambda *a: None),
                       {k: jnp.asarray(v.numpy()) for k, v in maps.items()},
                       jnp.asarray(vq, jnp.int32))
    assert len(tail) == len(jtail) == head.n_payload + 1
    for a, b in zip(tail, jtail):
        assert np.array_equal(a.numpy(), np.asarray(b))
    arrs = [t.numpy()[0] for t in tail[:head.n_payload]]
    payload = arrs[0] if head.n_payload == 1 else tuple(arrs)
    got, kind = head.decode(payload, valid)
    want = head.reference_decode(
        {k: v[0].numpy() for k, v in maps.items() if k != "logits"}, valid)
    jgot, jkind = jhead.decode(payload, valid)
    assert kind == jkind == "host"
    assert got, f"{name}: no box on the shared maps"
    assert sorted(b["box"] for b in got) == sorted(b["box"] for b in want)
    assert got == jgot
    for b in got:
        x0, y0, x1, y1 = b["box"]
        assert 0 <= x0 <= x1 < valid[1] // 4 and 0 <= y0 <= y1 < valid[0] // 4


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 40), st.integers(0, 40), st.integers(1, 30),
       st.integers(1, 30), st.integers(1, 60), st.integers(1, 60),
       st.sampled_from([0.5, 1.0, 1.5, 2.0, 3.0]))
def test_db_unclip_box_matches_reference(x0, y0, w, h, vw, vh, ratio):
    box = {"label": 1, "box": (x0, y0, x0 + w - 1, y0 + h - 1),
           "area": w * h}
    got = db_unclip_box(box, (vh, vw), ratio)
    assert got == j_db_unclip_box(box, (vh, vw), ratio)
    assert got is not box and box["box"] == (x0, y0, x0 + w - 1, y0 + h - 1)


BUCKETS = (64, 128)
HW = (64, 64)


def _keys(out):
    return [[(b["label"], b["box"], b["area"]) for b in r] for r in out]


def _services(model, score_thr=0.5, **kw):
    ref = JSTDService(width=0.125, buckets=BUCKETS, model=model,
                      score_thr=score_thr)
    tree = jax.tree_util.tree_map(np.asarray,
                                  ref.factory.params(HW, "f32", model))
    port = STDService(width=0.125, buckets=BUCKETS, model=model,
                      score_thr=score_thr, device="cpu", max_batch=4,
                      max_wait_ms=20, params=params_from_numpy(tree), **kw)
    return ref, port


@pytest.fixture(scope="module")
def requests():
    return RequestStream(6, seed=2, hw_range=((40, 120), (40, 120))).images()


def test_east_serves_like_the_jax_service(requests):
    """EAST through STDService: sequential, pipelined and micro-batched
    boxes all equal the JAX service's sequential boxes; the payload is a
    (score, geo) pair per image.  The random weights keep every score
    below 0.5 (about 10% of the pixels above 0.47), so both services
    threshold at 0.47."""
    ref, port = _services("east", score_thr=0.47)
    want = _keys([ref(img) for img in requests])
    assert sum(len(r) for r in want) > len(requests)
    assert _keys([port(img) for img in requests]) == want
    assert _keys(port.serve_pipelined(requests)) == want
    assert _keys(port.serve_batched(requests)) == want
    assert max(b["n"] for b in port.stats["batching"]["batches"]) > 1
    x, valid, _ = port.preprocess(requests[0])
    score, geo = port._finalize(port._dispatch(x[None], [valid]))[0]
    assert score.shape == (16, 16) and geo.shape == (16, 16, 4)
    assert np.array_equal(port.infer_labels(x[None], [valid])[0], score)
    assert all(e["model"] == "east" for e in port.factory.stats["compiled"])
    snap = port.book.snapshot()
    assert any('model="east"' in k for k in snap)
    assert not any('model="pixellink"' in k for k in snap)


def test_east_device_postprocess_raises():
    with pytest.raises(ValueError, match="no label-map payload"):
        STDService(width=0.125, buckets=BUCKETS, model="east",
                   postprocess="device", device="cpu")


def test_db_device_and_host_boxes_equal_jax(requests):
    """DB: the device box tail (sequential and micro-batched) gives the
    host tail's boxes, which equal the JAX service's."""
    ref, host = _services("db")
    want = _keys([ref(img) for img in requests])
    assert _keys([host(img) for img in requests]) == want
    _, dev = _services("db", postprocess="device", boxes_capacity=64)
    assert _keys([dev(img) for img in requests]) == want
    assert _keys(dev.serve_batched(requests)) == want
    assert sum(len(r) for r in want) > 0


@pytest.mark.parametrize("name", ["RESNET50", "VGG16", "SMOKE"])
def test_std_configs_match_reference(name):
    """The port's STD configurations equal the reference's field by field
    (the kernel switch is ``use_kernels`` in the port, ``use_pallas`` in
    the reference, and the port's is on by default)."""
    import dataclasses

    from repro.configs import pixellink_std as jcfgs
    from repro_torch.configs import pixellink_std as cfgs

    got = dataclasses.asdict(getattr(cfgs, name))
    want = dataclasses.asdict(getattr(jcfgs, name))
    assert got.pop("use_kernels") is True
    assert want.pop("use_pallas") is False
    assert got == want
    assert type(got["image_size"]) is type(want["image_size"])
