"""Atrous Spatial Pyramid Pooling.

Five branches — 1x1 conv, three 3x3 atrous convs (rates 6/12/18 at OS16,
doubled at OS8), global-average-pool + 1x1 — concatenated and projected to
256ch with BN/ReLU/Dropout(0.1). The JAX package's split projection
(aspp.py:47-77) avoids a TPU layout copy; here the concat is computed.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import ConvBNReLU


class ASPPPooling(nn.Module):
    def __init__(self, in_channels, out_channels, *, dtype=None,
                 generator=None):
        super().__init__()
        self.conv = ConvBNReLU(in_channels, out_channels, 1, dtype=dtype,
                               generator=generator)

    def forward(self, x):
        h, w = x.shape[-2:]
        # the mean is taken in f32 (aspp.py:24)
        pooled = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        pooled = self.conv(pooled)
        return pooled.expand(-1, -1, h, w)


class ASPP(nn.Module):
    def __init__(self, in_channels: int, atrous_rates: tuple[int, int, int],
                 out_channels: int = 256, *, dropout_rate: float = 0.1,
                 dtype=None, generator=None):
        super().__init__()
        r1, r2, r3 = atrous_rates
        kw = dict(dtype=dtype, generator=generator)
        self.branch1 = ConvBNReLU(in_channels, out_channels, 1, **kw)
        self.branch2 = ConvBNReLU(in_channels, out_channels, 3, padding=r1,
                                  dilation=r1, **kw)
        self.branch3 = ConvBNReLU(in_channels, out_channels, 3, padding=r2,
                                  dilation=r2, **kw)
        self.branch4 = ConvBNReLU(in_channels, out_channels, 3, padding=r3,
                                  dilation=r3, **kw)
        self.pool = ASPPPooling(in_channels, out_channels, **kw)
        self.project = ConvBNReLU(5 * out_channels, out_channels, 1, **kw)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x):
        feats = torch.cat([self.branch1(x), self.branch2(x), self.branch3(x),
                           self.branch4(x), self.pool(x)], dim=1)
        feats = feats.contiguous(memory_format=torch.channels_last)
        return self.dropout(self.project(feats))
