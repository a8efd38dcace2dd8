"""The plain reference against the port's CPU route at a small width:
the BFP step bit for bit, the forward within the rounding the sum order
moves, labels and boxes exactly."""
import numpy as np
import pytest
import torch

from perfbench.plain import bfp, cc, fcn
from perfbench.plain import layers as L


@pytest.mark.parametrize("bits", [7, 10])
@pytest.mark.parametrize("axis", [-1, -2])
def test_bfp_roundtrip_is_the_ports(bits, axis):
    from repro_torch.core import bfp as port

    g = torch.Generator().manual_seed(bits)
    x = torch.randn(3, 5, 70, 40, generator=g) * 10.0 ** torch.randint(
        -3, 3, (3, 5, 70, 40), generator=g)
    x[0, 0, :33] = 0.0
    want = port.roundtrip(x, block_size=32, mantissa_bits=bits, axis=axis)
    got = bfp.roundtrip(x, block_size=32, mantissa_bits=bits, axis=axis)
    assert torch.equal(got, want)


@pytest.mark.parametrize("backbone", ["vgg16", "resnet50"])
def test_forward_cc_and_boxes_match_the_port(backbone):
    from repro_torch.core import BFPConfig
    from repro_torch.models.fcn import DetectionModel, STDConfig, build_head
    from repro_torch.models.fcn import postprocess as pp

    hw, merge = (64, 96), (16, 16, 8)
    layers = L.pixellink(getattr(L, backbone)(0.125), merge)
    params = fcn.make_params(layers, 3_000_000_007, "cpu")
    model = DetectionModel(STDConfig(
        backbone=backbone, width=0.125, image_size=hw, merge_ch=merge,
        bfp=BFPConfig(), storage_fp16=True), build_head("pixellink"), "cpu")
    x = torch.rand(2, *hw, 3, generator=torch.Generator().manual_seed(1))
    out = model.apply(model.normalize_weights(params), x)
    logits, prob = fcn.forward(layers, params, x, block_size=32,
                               mantissa_bits=10)
    scale = float(logits.abs().max())
    # one FP16 rounding the sum order moves becomes one mantissa LSB
    # (2^-10 of the block) at the next BFP step; over ~30 words the
    # logits stay within a few 1e-3 of L (tests/test_torch_engine.py)
    assert float((out["logits"] - logits).abs().max()) < 1e-2 * scale
    control, _ = fcn.forward(layers, params, x, block_size=32,
                             mantissa_bits=7)
    assert float((control - logits).abs().max()) > 5e-2 * scale
    labels = pp.cc_label_batched(out["score"], out["links"])
    for i in range(2):
        ref = cc.labels(out["score"][i].numpy(), out["links"][i].numpy(),
                        (hw[0] // 4, hw[1] // 4), 0.5, 0.5)
        assert np.array_equal(ref, labels[i].numpy())
        got = [(b["label"], *b["box"], b["area"])
               for b in pp.boxes_from_labels(labels[i].numpy())]
        assert got == cc.boxes(ref)


def test_cc_respects_links_and_the_valid_region():
    score = np.zeros((4, 6), np.float32)
    score[1, 1:5] = 0.9
    links = np.zeros((4, 6, 8), np.float32)
    links[1, 1, 4] = 0.9            # (1,1) -> (1,2) only, from one side
    got = cc.labels(score, links, (4, 6), 0.5, 0.5)
    assert got[1, 1] == got[1, 2] == 1 * 6 + 2 + 1
    assert got[1, 3] == 1 * 6 + 3 + 1 and got[1, 4] == 1 * 6 + 4 + 1
    assert cc.labels(score, links, (4, 3), 0.5, 0.5)[1, 3] == 0
