"""The paper's own models: PixelLink STD with ResNet-50 (the deployed
configuration, §V.B) and VGG-16 (the Fig. 8b comparison point)."""
from repro_torch.core.interpreter import BFPConfig
from repro_torch.models.fcn.pixellink import STDConfig

# The configuration the paper deploys: ResNet-50 extractor, BFP numerics
# (FP16 storage, 10-bit mantissa blocks, wide accumulation).
RESNET50 = STDConfig(
    name="pixellink_resnet50",
    backbone="resnet50",
    image_size=(512, 512),
    mode="optimized",
    bfp=BFPConfig(block_size=32, mantissa_bits=10, wide_accum=True),
    storage_fp16=True,
)

VGG16 = STDConfig(
    name="pixellink_vgg16",
    backbone="vgg16",
    image_size=(512, 512),
    mode="optimized",
    bfp=BFPConfig(block_size=32, mantissa_bits=10, wide_accum=True),
    storage_fp16=True,
)

SMOKE = STDConfig(
    name="pixellink_smoke",
    backbone="vgg16",
    width=0.125,
    image_size=(64, 64),
    merge_ch=(16, 16, 8),
    mode="reference",
    storage_fp16=False,
)
