"""MobileNetV2 backbone with output-stride control (DeepLab variant).

Once the running stride reaches `output_stride`, later stage strides turn
into dilation. Low-level tap = output of features[0:4] (24ch, stride 4);
high-level tap = the last 320ch block (the 1x1 1280 head conv is dropped).

In eval mode without autograd, every inverted residual after the entry conv
runs through the folded-BN eval kernels (ops.irchain_eval): runs of
stride-1 blocks through kernel A, each stride-2 block through kernel B, as
`_call_eval_fused` does in the JAX package. The entry conv runs stock.

In train mode, features[0..2] run through the fused stem (ops.stem: the
entry-conv kernels, then the BN-barrier pass kernels) and features[3..6]
through the fused IR chain (ops.irchain) when the structural guards hold
(the JAX package's `_fused_stem_active` / `_fused_ir_active`, the first
also with `supports_host_s2d`'s entry-conv geometry); features[7..] run
their own modules, whose stride-1 depthwise convs `Conv2d` sends to
ops.dwconv. The JAX package takes its entry-conv kernels only on a
host-packed image of odd size; the port's kernels read the image itself,
at any size, so the chain starts from the image whenever the guard holds.
`_forward_modules` is the module path, every block on its own module.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.irchain import _BLOCKS, fused_ir_chain_sharded
from ..ops.irchain_eval import (fused_ir_block_s2_eval, fused_mnv2_blocks_eval,
                                ir_block_fusable, ir_block_s2_fusable)
from ..ops.stem import F0_MAX_C, fused_stem_f1f2_sharded
from ..parallel.mesh import sharded_group
from .layers import BatchNorm, Conv2d, update_bn_stats


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


def _pw_ok(conv, cin, cout):
    """A 1x1 dense conv cin -> cout without bias."""
    return (isinstance(conv, Conv2d) and conv.bias is None
            and tuple(conv.weight.shape) == (cout, cin, 1, 1)
            and conv.stride == (1, 1) and conv.groups == 1)


def _dw_ok(conv, c, stride):
    """A 3x3 depthwise conv over c channels, pad 1, dilation 1, no bias."""
    return (isinstance(conv, Conv2d) and conv.bias is None
            and tuple(conv.weight.shape) == (c, 1, 3, 3) and conv.groups == c
            and conv.stride == (stride, stride) and conv.padding == (1, 1)
            and conv.dilation == (1, 1))


def _entry_ok(conv):
    """The entry conv the f0 kernels compute: 3x3, stride 2, pad 1,
    dilation 1, 3 -> C0 (C0 % 8 == 0, at most F0_MAX_C), no bias."""
    c0 = conv.out_channels
    return (isinstance(conv, Conv2d) and conv.bias is None
            and tuple(conv.weight.shape) == (c0, 3, 3, 3)
            and conv.stride == (2, 2) and conv.padding == (1, 1)
            and conv.dilation == (1, 1) and conv.groups == 1
            and c0 % 8 == 0 and c0 <= F0_MAX_C)


def _bn_ok(bn, c):
    return (isinstance(bn, BatchNorm) and bn.num_features == c and bn.affine
            and bn.track_running_stats)


def _dw_param(conv):
    return conv.weight.reshape(conv.weight.shape[0], 9)


def _pw_param(conv):
    return conv.weight[:, :, 0, 0]


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

    def _fused_stem_active(self) -> bool:
        """Train mode, and features[0..2] as the fused stem computes them:
        the stock dense entry conv 3x3 / stride 2 / pad 1 (a backbone-scope
        cheap-conv surgery replaces it), then f1 = dw 3x3 -> 1x1 and
        f2 = 1x1 -> dw 3x3 s2 -> 1x1, no residuals, no other surgery."""
        if not self.training:
            return False
        try:
            f0, f1, f2 = self.features[0], self.features[1], self.features[2]
            c0 = f0.conv.out_channels
            c1, c2 = f1.pw_linear.out_channels, f2.body[0].conv.out_channels
            c3 = f2.pw_linear.out_channels
            return (_entry_ok(f0.conv) and _bn_ok(f0.bn, c0)
                    and len(f1.body) == 1 and len(f2.body) == 2
                    and not f1.use_res_connect and not f2.use_res_connect
                    and _dw_ok(f1.body[0].conv, c0, 1)
                    and _bn_ok(f1.body[0].bn, c0)
                    and _pw_ok(f1.pw_linear, c0, c1) and _bn_ok(f1.pw_bn, c1)
                    and _pw_ok(f2.body[0].conv, c1, c2)
                    and _bn_ok(f2.body[0].bn, c2)
                    and _dw_ok(f2.body[1].conv, c2, 2)
                    and _bn_ok(f2.body[1].bn, c2)
                    and _pw_ok(f2.pw_linear, c2, c3) and _bn_ok(f2.pw_bn, c3))
        except (AttributeError, IndexError):
            return False

    def _fused_ir_active(self) -> bool:
        """Train mode, and features[3..6] with the chain's `_BLOCKS` shapes,
        strides, dilation 1 and residual flags (no cheap-conv surgery)."""
        if not self.training:
            return False
        try:
            for i, (stride, cin, ce, cout, res) in enumerate(_BLOCKS):
                f = self.features[3 + i]
                if not (isinstance(f, InvertedResidual)
                        and f.use_res_connect == res and len(f.body) == 2
                        and _pw_ok(f.body[0].conv, cin, ce)
                        and _bn_ok(f.body[0].bn, ce)
                        and _dw_ok(f.body[1].conv, ce, stride)
                        and _bn_ok(f.body[1].bn, ce)
                        and _pw_ok(f.pw_linear, ce, cout)
                        and _bn_ok(f.pw_bn, cout)):
                    return False
            return True
        except (AttributeError, IndexError):
            return False

    def _stem_inputs(self, x):
        """(the image NHWC in the entry conv's compute dtype, the stem's
        param dict in f0 mode, its six BNs): w0 the entry conv's own
        weight, the others repacked to (C, 9) and (Co, Ci) views, so that
        autograd takes the chain's gradients back to them."""
        f0, f1, f2 = self.features[0], self.features[1], self.features[2]
        p = {"w0": f0.conv.weight,
             "k1": _dw_param(f1.body[0].conv), "w1": _pw_param(f1.pw_linear),
             "w2": _pw_param(f2.body[0].conv),
             "k2": _dw_param(f2.body[1].conv), "w3": _pw_param(f2.pw_linear)}
        bns = [f0.bn, f1.body[0].bn, f1.pw_bn, f2.body[0].bn, f2.body[1].bn,
               f2.pw_bn]
        for i, bn in enumerate(bns):
            p[f"g{i}"], p[f"b{i}"] = bn.weight, bn.bias
        dt = f0.conv.compute_dtype
        return _nhwc(x if dt is None else x.to(dt)), p, bns

    def _ir_params(self):
        """(IR-chain param dict, its twelve BNs in stats order)."""
        p, bns = {}, []
        for i in range(len(_BLOCKS)):
            f = self.features[3 + i]
            p[f"we{i}"] = _pw_param(f.body[0].conv)
            p[f"k{i}"] = _dw_param(f.body[1].conv)
            p[f"wp{i}"] = _pw_param(f.pw_linear)
            for tag, bn in (("e", f.body[0].bn), ("d", f.body[1].bn),
                            ("p", f.pw_bn)):
                p[f"g{tag}{i}"], p[f"b{tag}{i}"] = bn.weight, bn.bias
                bns.append(bn)
        return p, bns

    def _call_fused_stem(self, x):
        """features[0..2] through the fused stem, from the image. Returns
        the f2 output (NCHW view, channels_last)."""
        img, p, bns = self._stem_inputs(x)
        # the active group of more than one rank (JAX `_use_sharded`,
        # mobilenetv2.py:255-266): global moments; None: one process
        out, stats = fused_stem_f1f2_sharded(
            img, p, sharded_group(), float(self.features[0].bn.eps))
        update_bn_stats(bns, stats)
        return _nchw(out)

    def _call_fused_stem_ir(self, x):
        """features[0..6]: the fused stem hands its f2 output to the fused
        IR chain in NHWC, with no copy. Returns (f6 output, low_level = the
        f3 output), NCHW views in channels_last memory."""
        img, sp, sbns = self._stem_inputs(x)
        ip, ibns = self._ir_params()
        eps = float(self.features[0].bn.eps)
        group = sharded_group()
        z, sstats = fused_stem_f1f2_sharded(img, sp, group, eps)
        out, low, istats = fused_ir_chain_sharded(z, ip, group, eps)
        update_bn_stats(sbns, sstats)
        update_bn_stats(ibns, istats)
        return _nchw(out), _nchw(low)

    def _forward_modules(self, x, start=0, stop=None, low_level=None):
        """features[start:stop] on their own modules (the module path)."""
        for i, m in enumerate(self.features):
            if i < start:
                continue
            if stop is not None and i >= stop:
                break
            x = m(x)
            if i == 3:
                low_level = x
        return {"low_level": low_level, "out": x}

    def forward(self, x):
        # the eval kernels are forward-only: with autograd on in eval mode
        # every block runs its own module
        if not self.training and not torch.is_grad_enabled():
            return self._call_eval_fused(x)
        if self._fused_stem_active():
            if self._fused_ir_active():
                x, low_level = self._call_fused_stem_ir(x)
                return self._forward_modules(x, 7, low_level=low_level)
            return self._forward_modules(self._call_fused_stem(x), 3)
        return self._forward_modules(x)


def mobilenet_v2(*, output_stride=16, width_mult=1.0, dtype=None,
                 generator=None) -> MobileNetV2:
    return MobileNetV2(output_stride=output_stride, width_mult=width_mult,
                       dtype=dtype, generator=generator)
