"""The frozen layer lists against the port's LayerSpec lists and
programs at 512x512, and the operation and byte counts."""
import pytest

from perfbench import counts
from perfbench.plain import layers as L

FIELDS = ("name", "op", "out_ch", "kernel", "stride", "relu", "bn", "bias",
          "res")


def port_specs(backbone):
    from repro_torch.models.fcn import backbones, fusion

    specs, taps = backbones.BACKBONES[backbone](1.0)
    merge, feat = fusion.east_merge(taps, (128, 64, 32))
    head, _ = fusion.pixellink_head(feat)
    return specs + merge + head


@pytest.mark.parametrize("backbone,k1,k2,gflop", [
    ("vgg16", 17, 7, 162.37), ("resnet50", 17, 40, 45.22)])
def test_layer_lists_and_counts(backbone, k1, k2, gflop):
    from repro_torch.core import BFPConfig
    from repro_torch.models.fcn import DetectionModel, STDConfig, build_head

    frozen = L.pixellink(getattr(L, backbone)(1.0), (128, 64, 32))
    specs = port_specs(backbone)
    assert len(frozen) == len(specs)
    for ly, sp in zip(frozen, specs):
        assert {f: ly[f] for f in FIELDS} == {f: getattr(sp, f)
                                               for f in FIELDS}
        assert ly["inputs"] == list(sp.inputs)
    model = DetectionModel(STDConfig(backbone=backbone, bfp=BFPConfig()),
                           build_head("pixellink"), "cpu")
    prog = model.program
    shp = L.shapes(frozen, (512, 512))
    by_name = {sp.name: i for i, sp in prog.layer_specs.items()}
    for ly in frozen:
        mc = prog.words[by_name[ly["name"]]]
        assert prog.addr_shapes[mc.out_addr] == shp[ly["name"]]
    work = counts.layer_work(frozen, (512, 512))
    assert sum(r["class"] == "k1" for r in work) == k1 == len(
        model.engine.k1_shapes(1))
    assert sum(r["class"] == "k2" for r in work) == k2 == len(
        model.engine.k2_shapes(1))
    # K1's FLOPs from the port's own shapes: 2 x H x W x 9 x Cin x Cout
    port_k1 = sum(2 * h * w * 9 * ci * co
                  for _, _, h, w, ci, co in model.engine.k1_shapes(1))
    assert counts.total(work, "flops", "k1") == port_k1
    port_k2 = sum(2 * m * k * n for _, m, k, n in model.engine.k2_shapes(1))
    assert counts.total(work, "flops", "k2") == port_k2
    assert counts.total(work, "flops") / 1e9 == pytest.approx(gflop,
                                                            abs=0.01)


def test_bytes_and_bound_of_one_conv():
    ly = [L.layer("c", "conv", ["input"], 64, 3)]
    (r,) = counts.layer_work(ly, (8, 8))
    assert r["flops"] == 2 * 8 * 8 * 9 * 3 * 64
    assert r["bytes"] == 2 * (8 * 8 * 3 + 9 * 3 * 64 + 8 * 8 * 64)
    assert r["bound_s"] == max(r["flops"] / counts.PEAK_FLOPS,
                               r["bytes"] / counts.PEAK_BYTES)
