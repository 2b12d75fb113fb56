"""DeepLabV3 / DeepLabV3+ heads and the segmentation model wrapper.

- `DeepLabHeadV3Plus`: 1x1-project low-level features to 48ch, ASPP on the
  high-level features, bilinear-upsample the ASPP output to the low-level
  resolution (ops.upsample, where its guard holds), concat (304ch), one 3x3
  conv to 256ch, 1x1 classifier.
- `DeepLabHead` (V3, no decoder): ASPP -> 3x3 conv 256 -> 1x1 classifier.
- `SegmentationModel`: backbone -> head -> bilinear upsample to input size;
  `upsample=False` returns head-resolution logits (for the upsample-fused
  loss), `return_features=True` adds the KD hint taps 'low_level', 'out'
  (backbone) and 'head' (the fused 256ch decoder features).

In train mode, with the cheap-conv (separable) fuse conv, the fuse conv,
its BN, relu and the classifier run as the fused decoder head
(ops.decoder, the JAX package's `_call_fused_head_nw` path), which never
builds the 304-channel concat; `_forward_modules` is the module path. The
JAX package's split-concat head and its NW/NHCW layouts are TPU layout
workarounds and are not carried over.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.decoder import fused_decoder_head, fused_head_supported
from ..ops.resize import resize_bilinear
from ..ops.upsample import resize_bilinear_up, supports_upsample
from .aspp import ASPP
from .layers import BatchNorm, Conv2d, ConvBNReLU, update_bn_stats


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()  # free for channels_last


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

    def _fused_head_active(self, return_features: bool) -> bool:
        """The JAX package's guard (deeplab.py:39-53): the fuse BN in train
        mode; the fuse conv a separable dw 3x3 / stride 1 / dilation 1 /
        pad 1 with groups = Ci and a bias-free pw 1x1; a 1x1 classifier
        with a bias; no hint taps. For the kernels' 16-byte channel groups:
        the low and up widths divisible by 8, Cm by 16 (up to 256), up to
        32 classes (the TPU's Ci % 8 sublane rule is not carried over)."""
        if return_features or not self.training:
            return False
        try:
            sep, bn, cls = self.fuse.conv, self.fuse.bn, self.classifier
            dw, pw = sep.depthwise, sep.pointwise
            cl = self.project.conv.out_channels
            return (isinstance(bn, BatchNorm) and bn.training
                    and bn.track_running_stats and bn.affine
                    and self.fuse.relu
                    and dw.kernel_size == (3, 3) and dw.stride == (1, 1)
                    and dw.dilation == (1, 1) and dw.padding == (1, 1)
                    and dw.groups == dw.in_channels and dw.bias is None
                    and pw.bias is None and pw.kernel_size == (1, 1)
                    and pw.groups == 1
                    and cls.kernel_size == (1, 1) and cls.bias is not None
                    and cls.groups == 1
                    and fused_head_supported(cl, dw.in_channels - cl,
                                             pw.out_channels,
                                             cls.out_channels))
        except AttributeError:
            return False

    def _head_params(self):
        """The fused head's params as views of the module's weights, so
        that autograd takes their gradients back to them."""
        sep = self.fuse.conv
        dw = sep.depthwise.weight
        return {"k": dw.reshape(dw.shape[0], 9),
                "pw": sep.pointwise.weight[:, :, 0, 0],
                "g": self.fuse.bn.weight, "b": self.fuse.bn.bias,
                "wc": self.classifier.weight[:, :, 0, 0],
                "bc": self.classifier.bias}

    def _call_fused_head(self, low, up):
        """low, up (NCHW, channels_last) -> the fused head -> logits (an
        NCHW view in channels_last memory); the fuse BN's running
        statistics updated as its module would update them."""
        dt = self.fuse.conv.depthwise.compute_dtype
        if dt is not None:
            low, up = low.to(dt), up.to(dt)
        bn = self.fuse.bn
        logits, stats = fused_decoder_head(_nhwc(low), _nhwc(up),
                                           self._head_params(), float(bn.eps))
        update_bn_stats([bn], [stats])
        return logits.permute(0, 3, 1, 2)

    def _forward_modules(self, features: dict, return_features: bool = False):
        """The module path: the concat, the fuse and classifier modules."""
        low, x = self._low_up(features)
        x = torch.cat([low, x], dim=1).contiguous(
            memory_format=torch.channels_last)
        x = self.fuse(x)
        logits = self.classifier(x)
        return (logits, {"head": x}) if return_features else logits

    def upsample_active(self, x, size) -> bool:
        """The upsample kernel's guard (ops.upsample.supports_upsample) for
        the ASPP output x (NCHW) resized to `size`."""
        n, c, h, w = x.shape
        return supports_upsample((n, h, w, c), size, x.dtype)

    def _low_up(self, features):
        """The projected low-level features and the ASPP output upsampled to
        their size: through ops.upsample where its guard holds (the JAX
        decoder's `resize_bilinear_up`, deeplab.py:204-227), whose NHWC
        output the fused head reads without a copy."""
        low = self.project(features["low_level"])
        x = self.aspp(features["out"])
        size = tuple(low.shape[-2:])
        if self.upsample_active(x, size):
            return low, resize_bilinear_up(x, size, layout="NCHW")
        return low, resize_bilinear(x, size)

    def forward(self, features: dict, *, return_features: bool = False):
        if not self._fused_head_active(return_features):
            return self._forward_modules(features, return_features)
        return self._call_fused_head(*self._low_up(features))


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
