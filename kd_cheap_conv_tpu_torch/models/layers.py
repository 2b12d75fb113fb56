"""Shared building blocks (NCHW tensors in channels_last memory).

Parameters and BatchNorm statistics stay float32; with a compute `dtype`
(bfloat16 under --bf16) a conv casts its input and weights to it, and the
BatchNorm keeps the activation in that dtype, as in the JAX package's
models/layers.py. Initialisation follows it too: kaiming-normal fan-out
(truncated at two standard deviations) for conv kernels, zero conv biases,
BatchNorm2d defaults. Every random draw takes an explicit torch.Generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# torch BatchNorm2d(momentum=0.1) is flax BatchNorm(momentum=0.9): torch
# updates ra = (1 - m) * ra + m * batch, flax ra = m * ra + (1 - m) * batch.
TORCH_DEFAULT_BN_MOMENTUM = 0.1


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class Conv2d(nn.Conv2d):
    """torch Conv2d with the JAX package's init and an optional compute
    dtype (params stay float32)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, *,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 use_bias: bool = True, dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__(in_channels, out_channels, _pair(kernel_size),
                         stride=_pair(stride), padding=_pair(padding),
                         dilation=_pair(dilation), groups=groups,
                         bias=use_bias)
        self.compute_dtype = dtype
        # variance_scaling(2.0, "fan_out", "truncated_normal"): the std of
        # the untruncated normal is divided by the truncated one's (0.8796)
        kh, kw = self.kernel_size
        std = math.sqrt(2.0 / (kh * kw * out_channels)) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        w, b = self.weight, self.bias
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
            w = w.to(self.compute_dtype)
            b = b.to(self.compute_dtype) if b is not None else None
        return F.conv2d(x, w, b, self.stride, self.padding, self.dilation,
                        self.groups)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d, eps 1e-5, f32 affine and statistics. A bfloat16 input
    stays bfloat16 (the mixed-dtype batch-norm path).

    In train mode the running variance moves toward the *biased* batch
    variance, as flax's nnx.BatchNorm (the JAX package's BatchNorm) does;
    torch's BatchNorm2d would use the unbiased one, n/(n-1) larger. The
    normalisation is unchanged (biased in both), and so are the torch
    momentum convention and num_batches_tracked. The batch variance is read
    back from the inverse std that the batch-norm op saves for its backward,
    so no extra pass over the activation is made."""

    def __init__(self, num_features: int, *,
                 momentum: float = TORCH_DEFAULT_BN_MOMENTUM,
                 eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            m = (self.momentum if self.momentum is not None
                 else 1.0 / float(self.num_batches_tracked))
            var = invstd.float().pow(-2).sub_(self.eps)
            self.running_mean.mul_(1.0 - m).add_(mean.float(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return y


class ConvBNReLU(nn.Module):
    """Conv -> BN -> (optional) ReLU."""

    def __init__(self, in_channels, out_channels, kernel_size, *, stride=1,
                 padding=0, dilation=1, groups=1, relu=True, dtype=None,
                 generator=None):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           stride=stride, padding=padding, dilation=dilation,
                           groups=groups, use_bias=False, dtype=dtype,
                           generator=generator)
        self.bn = BatchNorm(out_channels)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class SeparableConv2d(nn.Module):
    """Depthwise kxk + pointwise 1x1, with BN between (Xception style) or
    not. `fixed_pad` applies Xception's explicit SAME padding before a VALID
    depthwise conv."""

    def __init__(self, in_channels, out_channels, kernel_size=3, *, stride=1,
                 padding=0, dilation=1, use_bias=False, bn_between=False,
                 fixed_pad=False, dtype=None, generator=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.depthwise = Conv2d(in_channels, in_channels, (kh, kw),
                                stride=stride,
                                padding=0 if fixed_pad else padding,
                                dilation=dilation, groups=in_channels,
                                use_bias=use_bias, dtype=dtype,
                                generator=generator)
        self.bn_dw = BatchNorm(in_channels) if bn_between else None
        self.pointwise = Conv2d(in_channels, out_channels, 1,
                                use_bias=use_bias, dtype=dtype,
                                generator=generator)
        self.fixed_pad = fixed_pad
        self._k = (kh, kw)
        self._dilation = _pair(dilation)

    def forward(self, x):
        if self.fixed_pad:
            pads = []
            for k, d in zip(reversed(self._k), reversed(self._dilation)):
                total = k + (k - 1) * (d - 1) - 1
                pads += [total // 2, total - total // 2]
            x = F.pad(x, pads)
        x = self.depthwise(x)
        if self.bn_dw is not None:
            x = self.bn_dw(x)
        return self.pointwise(x)


def set_bn_momentum(module: nn.Module, torch_momentum: float = 0.01) -> None:
    """The reference's `utils.set_bn_momentum(backbone, momentum=0.01)`."""
    for m in module.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.momentum = torch_momentum
