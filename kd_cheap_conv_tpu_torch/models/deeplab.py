"""DeepLabV3 / DeepLabV3+ heads and the segmentation model wrapper.

- `DeepLabHeadV3Plus`: 1x1-project low-level features to 48ch, ASPP on the
  high-level features, bilinear-upsample the ASPP output to the low-level
  resolution, concat (304ch), one 3x3 conv to 256ch, 1x1 classifier.
- `DeepLabHead` (V3, no decoder): ASPP -> 3x3 conv 256 -> 1x1 classifier.
- `SegmentationModel`: backbone -> head -> bilinear upsample to input size;
  `upsample=False` returns head-resolution logits (for the upsample-fused
  loss), `return_features=True` adds the KD hint taps 'low_level', 'out'
  (backbone) and 'head' (the fused 256ch decoder features).

The decoder concat is computed (the JAX package's split and fused heads are
TPU layout workarounds).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.resize import resize_bilinear
from .aspp import ASPP
from .layers import Conv2d, ConvBNReLU


class DeepLabHeadV3Plus(nn.Module):
    def __init__(self, in_channels: int, low_level_channels: int,
                 num_classes: int, aspp_dilate=(6, 12, 18), *, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.project = ConvBNReLU(low_level_channels, 48, 1, **kw)
        self.aspp = ASPP(in_channels, tuple(aspp_dilate), **kw)
        self.fuse = ConvBNReLU(304, 256, 3, padding=1, **kw)
        self.classifier = Conv2d(256, num_classes, 1, **kw)

    def forward(self, features: dict, *, return_features: bool = False):
        low = self.project(features["low_level"])
        x = self.aspp(features["out"])
        x = resize_bilinear(x, low.shape[-2:])
        x = torch.cat([low, x], dim=1).contiguous(
            memory_format=torch.channels_last)
        x = self.fuse(x)
        logits = self.classifier(x)
        return (logits, {"head": x}) if return_features else logits


class DeepLabHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int,
                 aspp_dilate=(6, 12, 18), *, dtype=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.aspp = ASPP(in_channels, tuple(aspp_dilate), **kw)
        self.fuse = ConvBNReLU(256, 256, 3, padding=1, **kw)
        self.classifier = Conv2d(256, num_classes, 1, **kw)

    def forward(self, features: dict, *, return_features: bool = False):
        x = self.fuse(self.aspp(features["out"]))
        logits = self.classifier(x)
        return (logits, {"head": x}) if return_features else logits


class SegmentationModel(nn.Module):
    """backbone -> head -> bilinear upsample to the input size.

    Takes and returns NCHW tensors. By default the logits stay in
    channels_last memory (physically NHWC, the JAX package's default
    layout). With `class_major=True` they are made class-major before the
    upsample, so the 16x bilinear and every later per-class pass run on
    contiguous (N, C, H, W) planes, as the JAX package's class_major path
    does. The two agree to float rounding.
    """

    def __init__(self, backbone: nn.Module, classifier: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.classifier = classifier

    def forward(self, x, *, return_features: bool = False,
                class_major: bool = False, upsample: bool = True):
        feats = self.backbone(x)
        if return_features:
            logits, head_feats = self.classifier(feats, return_features=True)
        else:
            logits = self.classifier(feats)
        if class_major:
            logits = logits.contiguous()
        if upsample:
            logits = resize_bilinear(logits, x.shape[-2:])
        if return_features:
            return logits, {"low_level": feats["low_level"],
                            "out": feats["out"], **head_feats}
        return logits
