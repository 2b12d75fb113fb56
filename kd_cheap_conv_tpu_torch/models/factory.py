"""Model factory — the JAX package's public model names.

`deeplabv3{,plus}_{resnet50,resnet101,mobilenet,xception}(num_classes,
output_stride)`; ASPP rates follow the output stride (6/12/18 at OS16,
12/24/36 at OS8). The MobileNetV2 and ResNet backbones are ported; the
Xception builder raises, naming its ROADMAP item. Models are built on
the CPU from a torch.Generator, so the same seed gives the same weights on
any device; move them with `.to(device, memory_format=torch.channels_last)`.
"""

from __future__ import annotations

import torch

from .deeplab import DeepLabHead, DeepLabHeadV3Plus, SegmentationModel
from .mobilenetv2 import mobilenet_v2
from .resnet import resnet50, resnet101


def _aspp_dilate(output_stride: int) -> tuple[int, int, int]:
    return (12, 24, 36) if output_stride == 8 else (6, 12, 18)


def _not_ported(name):
    def fn(**_):
        raise NotImplementedError(
            f"the {name} backbone is not ported yet (ROADMAP.md, Queue 1 "
            f"item 7: Xception)")
    return fn


_BACKBONES = {
    "resnet50": resnet50,
    "resnet101": resnet101,
    "mobilenet": mobilenet_v2,
    "xception": _not_ported("xception"),
}


def _build(arch, backbone_name, num_classes, output_stride, *, dtype,
           generator) -> SegmentationModel:
    backbone = _BACKBONES[backbone_name](output_stride=output_stride,
                                         dtype=dtype, generator=generator)
    rates = _aspp_dilate(output_stride)
    if arch == "deeplabv3plus":
        head = DeepLabHeadV3Plus(backbone.out_channels,
                                 backbone.low_level_channels, num_classes,
                                 rates, dtype=dtype, generator=generator)
    elif arch == "deeplabv3":
        head = DeepLabHead(backbone.out_channels, num_classes, rates,
                           dtype=dtype, generator=generator)
    else:
        raise ValueError(f"unknown arch {arch!r}")
    return SegmentationModel(backbone, head)


def _factory(arch, backbone_name):
    def fn(num_classes: int = 21, output_stride: int = 16, *,
           dtype: torch.dtype | None = None,
           generator: torch.Generator | None = None) -> SegmentationModel:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return _build(arch, backbone_name, num_classes, output_stride,
                      dtype=dtype, generator=generator)

    fn.__name__ = f"{arch}_{backbone_name}"
    return fn


MODEL_FACTORY = {
    f"{arch}_{bb}": _factory(arch, bb)
    for arch in ("deeplabv3", "deeplabv3plus")
    for bb in ("resnet50", "resnet101", "mobilenet", "xception")
}


def build_model(name: str, num_classes: int, output_stride: int = 16, *,
                dtype: torch.dtype | None = None,
                generator: torch.Generator | None = None
                ) -> SegmentationModel:
    """Model-name string -> assembled model on the CPU, in train mode."""
    if name not in MODEL_FACTORY:
        raise ValueError(f"unknown model {name!r}; choose from "
                         f"{sorted(MODEL_FACTORY)}")
    return MODEL_FACTORY[name](num_classes, output_stride, dtype=dtype,
                               generator=generator)
