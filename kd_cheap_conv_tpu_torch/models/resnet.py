"""ResNet-50/101 backbones with dilated final stages (DeepLab style), the
JAX package's models/resnet.py.

`replace_stride_with_dilation` keeps the output stride at 8 or 16: when a
stage is dilated, its stride moves into `dilation *= stride` and the first
block keeps the *previous* dilation for its 3x3 conv (the torchvision scheme
the reference inherits). Returns {'low_level': layer1 (256ch, stride 4),
'out': layer4 (2048ch)}. Module paths are the JAX package's (`stem.conv`,
`layer3.7.conv2`, `layer1.0.downsample.bn`, ...), so convert.py loads a JAX
teacher strictly.

In eval mode without autograd (the KD step's teacher), the stem conv7x7/s2
+ BN + relu + maxpool3x3/s2 runs as one kernel (ops.tstem, the JAX
package's `fused_stem_pool_eval_nhcw`, which it takes under KDCC_TSTEM=1)
whenever its geometry holds; otherwise, and in train mode, the stem runs its
modules. The JAX package's space-to-depth and host-packed stems are TPU
layouts and are not carried over; its fused eval bottleneck chains are not
ported yet: every block runs its own convs.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.tstem import fused_stem_pool_eval, stem_pool_eval_fusable
from .layers import BatchNorm, Conv2d, ConvBNReLU


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, *, stride=1, dilation=1,
                 downsample=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(use_bias=False, dtype=dtype, generator=generator)
        self.conv1 = Conv2d(inplanes, planes, 1, **kw)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride,
                            padding=dilation, dilation=dilation, **kw)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, **kw)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class _Downsample(nn.Module):
    def __init__(self, in_ch, out_ch, stride, *, dtype=None, generator=None):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 1, stride=stride, use_bias=False,
                           dtype=dtype, generator=generator)
        self.bn = BatchNorm(out_ch)

    def forward(self, x):
        return self.bn(self.conv(x))


class ResNet(nn.Module):
    """Dilated ResNet returning {'low_level': layer1, 'out': layer4}."""

    def __init__(self, layers: tuple[int, ...], *, output_stride: int = 16,
                 dtype=None, generator=None):
        super().__init__()
        dilate = {16: (False, False, True), 8: (False, True, True),
                  32: (False, False, False)}.get(output_stride)
        if dilate is None:
            raise ValueError(f"output_stride must be 8/16/32, got "
                             f"{output_stride}")
        kw = dict(dtype=dtype, generator=generator)
        self.stem = ConvBNReLU(3, 64, 7, stride=2, padding=3, **kw)
        self._inplanes = 64
        self._dilation = 1
        self.layer1 = self._make_layer(64, layers[0], 1, False, **kw)
        self.layer2 = self._make_layer(128, layers[1], 2, dilate[0], **kw)
        self.layer3 = self._make_layer(256, layers[2], 2, dilate[1], **kw)
        self.layer4 = self._make_layer(512, layers[3], 2, dilate[2], **kw)
        self.low_level_channels = 256
        self.out_channels = 2048

    def _make_layer(self, planes, blocks, stride, dilate, *, dtype,
                    generator):
        previous_dilation = self._dilation
        if dilate:
            self._dilation *= stride
            stride = 1
        out_ch = planes * Bottleneck.expansion
        downsample = None
        if stride != 1 or self._inplanes != out_ch:
            downsample = _Downsample(self._inplanes, out_ch, stride,
                                     dtype=dtype, generator=generator)
        layer = [Bottleneck(self._inplanes, planes, stride=stride,
                            dilation=previous_dilation, downsample=downsample,
                            dtype=dtype, generator=generator)]
        self._inplanes = out_ch
        for _ in range(1, blocks):
            layer.append(Bottleneck(self._inplanes, planes,
                                    dilation=self._dilation, dtype=dtype,
                                    generator=generator))
        return nn.ModuleList(layer)

    def _fused_stem_eval_active(self) -> bool:
        """Eval mode, no autograd, and the stem the kernel computes."""
        return (not self.training and not torch.is_grad_enabled()
                and self.stem.relu
                and stem_pool_eval_fusable(self.stem.conv, self.stem.bn))

    def _stem_pool(self, x):
        if self._fused_stem_eval_active():
            dt = self.stem.conv.compute_dtype
            img = (x if dt is None else x.to(dt)).permute(0, 2, 3, 1)
            y = fused_stem_pool_eval(img.contiguous(), self.stem.conv,
                                     self.stem.bn)
            return y.permute(0, 3, 1, 2)      # NCHW view, channels_last
        # torch MaxPool2d(3, 2, 1): the padding is -inf, as in the JAX
        # package's reduce_window
        return F.max_pool2d(self.stem(x), 3, 2, 1)

    def forward(self, x):
        x = self._stem_pool(x)
        for b in self.layer1:
            x = b(x)
        low_level = x
        for layer in (self.layer2, self.layer3, self.layer4):
            for b in layer:
                x = b(x)
        return {"low_level": low_level, "out": x}


def resnet50(*, output_stride=16, dtype=None, generator=None) -> ResNet:
    return ResNet((3, 4, 6, 3), output_stride=output_stride, dtype=dtype,
                  generator=generator)


def resnet101(*, output_stride=16, dtype=None, generator=None) -> ResNet:
    return ResNet((3, 4, 23, 3), output_stride=output_stride, dtype=dtype,
                  generator=generator)
