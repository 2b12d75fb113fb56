"""MobileNetV2 backbone with output-stride control (DeepLab variant).

Once the running stride reaches `output_stride`, later stage strides turn
into dilation. Low-level tap = output of features[0:4] (24ch, stride 4);
high-level tap = the last 320ch block (the 1x1 1280 head conv is dropped).

In eval mode without autograd, every inverted residual after the entry conv
runs through the folded-BN eval kernels (ops.irchain_eval): runs of
stride-1 blocks through kernel A, each stride-2 block through kernel B, as
`_call_eval_fused` does in the JAX package. The entry conv runs stock.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.irchain_eval import (fused_ir_block_s2_eval, fused_mnv2_blocks_eval,
                                ir_block_fusable, ir_block_s2_fusable)
from .layers import BatchNorm, Conv2d


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU6(nn.Module):
    def __init__(self, in_ch, out_ch, kernel_size=3, *, stride=1, dilation=1,
                 groups=1, dtype=None, generator=None):
        super().__init__()
        pad = (kernel_size - 1) // 2 * dilation
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                           padding=pad, dilation=dilation, groups=groups,
                           use_bias=False, dtype=dtype, generator=generator)
        self.bn = BatchNorm(out_ch)

    def forward(self, x):
        return F.relu6(self.bn(self.conv(x)))


class InvertedResidual(nn.Module):
    def __init__(self, inp, oup, *, stride=1, dilation=1, expand_ratio=6,
                 dtype=None, generator=None):
        super().__init__()
        assert stride in (1, 2)
        hidden = int(round(inp * expand_ratio))
        self.use_res_connect = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU6(inp, hidden, 1, dtype=dtype,
                                      generator=generator))
        layers.append(ConvBNReLU6(hidden, hidden, 3, stride=stride,
                                  dilation=dilation, groups=hidden,
                                  dtype=dtype, generator=generator))
        self.body = nn.ModuleList(layers)
        self.pw_linear = Conv2d(hidden, oup, 1, use_bias=False, dtype=dtype,
                                generator=generator)
        self.pw_bn = BatchNorm(oup)

    def forward(self, x):
        out = x
        for m in self.body:
            out = m(out)
        out = self.pw_bn(self.pw_linear(out))
        return x + out if self.use_res_connect else out


# (expand_ratio t, channels c, repeats n, stride s)
_INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()  # free for channels_last


def _nchw(y):
    return y.permute(0, 3, 1, 2)  # an NCHW view in channels_last memory


class MobileNetV2(nn.Module):
    """Returns {'low_level': 24ch stride-4, 'out': 320ch stride-OS}."""

    def __init__(self, *, output_stride: int = 16, width_mult: float = 1.0,
                 dtype=None, generator=None):
        super().__init__()
        input_channel = _make_divisible(32 * width_mult)
        features = [ConvBNReLU6(3, input_channel, 3, stride=2, dtype=dtype,
                                generator=generator)]
        current_stride = 2
        dilation = 1
        for t, c, n, s in _INVERTED_RESIDUAL_SETTING:
            previous_dilation = dilation
            if current_stride == output_stride:
                stride = 1
                dilation *= s
            else:
                stride = s
                current_stride *= s
            output_channel = _make_divisible(c * width_mult)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, output_channel,
                    stride=stride if i == 0 else 1,
                    dilation=previous_dilation if i == 0 else dilation,
                    expand_ratio=t, dtype=dtype, generator=generator))
                input_channel = output_channel
        self.features = nn.ModuleList(features)
        self.low_level_channels = _make_divisible(24 * width_mult)
        self.out_channels = input_channel  # 320

    def _call_eval_fused(self, x):
        """Group consecutive stride-1 InvertedResiduals into kernel-A runs;
        stride-2 blocks go through kernel B, the entry conv runs stock."""
        low_level = None
        run = []

        def flush(x):
            if run:
                x = _nchw(fused_mnv2_blocks_eval(_nhwc(x), tuple(run)))
                run.clear()
            return x

        for i, m in enumerate(self.features):
            if i > 0 and ir_block_fusable(m):
                run.append(m)
            elif i > 0 and ir_block_s2_fusable(m):
                x = _nchw(fused_ir_block_s2_eval(_nhwc(flush(x)), m))
            else:
                x = m(flush(x))
            if i == 3:
                x = flush(x)
                low_level = x
        return {"low_level": low_level, "out": flush(x)}

    def forward(self, x):
        # the eval kernels are forward-only: with autograd on, or in train
        # mode (batch statistics), every block runs its own module
        if not self.training and not torch.is_grad_enabled():
            return self._call_eval_fused(x)
        low_level = None
        for i, m in enumerate(self.features):
            x = m(x)
            if i == 3:
                low_level = x
        return {"low_level": low_level, "out": x}


def mobilenet_v2(*, output_stride=16, width_mult=1.0, dtype=None,
                 generator=None) -> MobileNetV2:
    return MobileNetV2(output_stride=output_stride, width_mult=width_mult,
                       dtype=dtype, generator=generator)
