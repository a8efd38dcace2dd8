"""The slice end to end: repro_torch's STDService against the JAX
STDService with the same weights, on the same 4 RequestStream(4, seed=0)
requests, image to boxes.

f32: label maps and boxes are exactly equal.  bfp (FP16 storage): the
score and link maps agree within the engine tolerance stated in
test_torch_engine (2e-2), and the boxes are equal on this seed.
"""
import sys
import subprocess

import jax
import numpy as np
import pytest
import torch

from repro.data.images import RequestStream as JRequestStream
from repro.launch.serve import STDService as JSTDService
from repro_torch.data.images import RequestStream
from repro_torch.launch.serve import STDService
from repro_torch.models.fcn import params_from_numpy
from repro_torch.runtime.executor import EngineFactory

torch.set_num_threads(2)

BUCKETS = (64, 128)
HW = (64, 64)


def _boxes(out):
    return [[(b["label"], b["box"], b["area"]) for b in r] for r in out]


@pytest.fixture(scope="module")
def requests():
    images = RequestStream(4, seed=0).images()
    want = JRequestStream(4, seed=0).images()
    assert all(np.array_equal(a, b) for a, b in zip(images, want))
    return images


def _services(precision):
    ref = JSTDService(width=0.125, buckets=BUCKETS, precision=precision)
    tree = jax.tree_util.tree_map(
        np.asarray, ref.factory.params(HW, "f32", "pixellink"))
    port = STDService(width=0.125, buckets=BUCKETS, precision=precision,
                      device="cpu", params=params_from_numpy(tree))
    return ref, port


def test_f32_labels_and_boxes_exact(requests):
    ref, port = _services("f32")
    for img in requests:
        x, valid, _ = port.preprocess(img)
        xr, valid_r, _ = ref.preprocess(img)
        assert np.array_equal(x, xr) and valid == valid_r
        got = port.infer_labels(x[None], [valid])
        want = ref.infer_labels(x[None], [valid])
        assert np.array_equal(got, want)
    assert _boxes([port(i) for i in requests]) == \
        _boxes([ref(i) for i in requests])
    assert port.stats["n"] == 4 and port.stats["nonconverged"] == 0


def test_bfp_maps_within_tolerance_and_boxes_equal(requests):
    ref, port = _services("bfp")
    apply = {}
    for img in requests:
        x, valid, _ = port.preprocess(img)
        hw = x.shape[:2]
        if hw not in apply:
            apply[hw] = jax.jit(ref.factory.model(hw, "bfp", "pixellink").apply)
        want = apply[hw](ref.factory.params(hw, "bfp", "pixellink"), x[None])
        got = port.factory.model(hw, "bfp").apply(
            port.factory.params(hw, "bfp"), torch.from_numpy(x[None]))
        for name in ("score", "links"):
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]), atol=2e-2)
    assert _boxes([port(i) for i in requests]) == \
        _boxes([ref(i) for i in requests])


def test_unported_options_raise():
    """Plans, tall plans and planners are ported; what is not one of them
    is refused."""
    kw = dict(width=0.125, buckets=BUCKETS, device="cpu")
    for bad in (dict(planner=object()), dict(tall_plan=object()),
                dict(plan=object())):
        with pytest.raises(TypeError):
            STDService(**kw, **bad)
    for model in ("east", "db"):
        assert STDService(**kw, model=model).head.name == model
    for bad in (dict(model="craft"), dict(postprocess="gpu"),
                dict(postprocess="device", boxes_capacity=0),
                dict(model="east", postprocess="device"),
                dict(max_batch=0), dict(inflight=-1)):
        with pytest.raises(ValueError):
            STDService(**kw, **bad)


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        STDService(width=0.125)
    with pytest.raises(RuntimeError, match="cuda"):
        EngineFactory(lambda *a: None)


def test_port_imports_without_jax(tmp_path):
    """repro_torch imports, builds a model and serves on the CPU in a
    process that never loads JAX or the reference package."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from repro_torch.launch.serve import STDService\n"
        "from repro_torch.data.images import RequestStream\n"
        "import repro_torch.kernels.cc_label, repro_torch.configs.pixellink_std\n"
        "import repro_torch.runtime.telemetry, repro_torch.runtime.pipeline\n"
        "import repro_torch.launch.batching, repro_torch.launch.mesh\n"
        "import repro_torch.runtime.planner, repro_torch.runtime.sharding\n"
        "import repro_torch.runtime.collectives, repro_torch.core.rowband\n"
        "svc = STDService(width=0.125, buckets=(64,), device='cpu')\n"
        "svc(RequestStream(1, seed=0, hw_range=((48, 64), (48, 64))).images()[0])\n"
        "dev = STDService(width=0.125, buckets=(64,), device='cpu',\n"
        "                 postprocess='device', max_batch=2)\n"
        "imgs = RequestStream(3, seed=1, hw_range=((48, 64), (48, 64))).images()\n"
        "assert dev.serve_batched(imgs) == [svc(i) for i in imgs]\n"
        "assert dev.metrics_snapshot()['std_mb_submitted'] == 3\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    import os

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=tmp_path,
                   env={**os.environ, "PYTHONPATH": src})
