"""Modified aligned Xception-65 backbone (DeepLabV3+, config #3).

Counterpart of kd_cheap_conv_tpu/models/xception.py, with its module paths
(`conv1`, `conv2`, `block1..3`, `middle.0..15`, `exit_block`,
`exit_sep1..3`; per separable conv `sep.depthwise`, `sep.bn_dw`,
`sep.pointwise`, `bn`; per block `skip_conv`, `skip_bn`), so that a JAX
model's leaves load through convert.state_dict_from_jax.

- entry: conv 3x3/2 (32) -> conv 3x3 (64) -> block1 (128, s2)
         -> block2 (256, s2) -> block3 (728, s2 or dilated)
- middle: 16 residual blocks of 3 sep convs (728)
- exit: block (728 -> 1024, s2 or dilated) -> sep 1536 -> sep 1536 -> sep 2048
Low-level decoder tap: the block1 output (128 channels, stride 4).

In train mode the entry blocks, the middle flow and the exit flow run as
chains of BN-barrier pass kernels (ops.xchain) where the structural guards
hold (`_fused_entry_ok`, `_fused_middle_active`, `_fused_tail_active`, the
train halves of the JAX package's guards), as the JAX package runs them by
default; their running statistics move through `update_bn_stats`. The
chains' depthwise passes take the dilations of ops.stem.DW_DILATIONS: at
OS16 the middle flow runs at dilation 1 and the exit flow at 2, at OS8 at 2
and 4 (block3 has stride 1 there and runs on its modules, as in the JAX
package); at OS32 the exit flow has stride 2 and runs on its modules. In eval
mode without autograd (the config-#3 teacher, Xception serving) they run as
the eval chains (ops.xchain_eval: every BN folded, each middle- and
exit-flow sep conv one launch of the folded separable-conv kernel, the
entry blocks on the pass kernels with running-statistic packs) where
`_fused_entry_eval_ok`, `_fused_middle_eval_active` and
`_fused_tail_eval_active` hold: the JAX package's graph with
KDCC_XMID_EVAL=1 (its default keeps them off for a TPU fault that does not
carry over). In eval mode with autograd on, every block runs its modules.
conv1 and conv2 always run as their modules (the JAX package's host
space-to-depth entry is a TPU layout and is not carried over).
`_forward_modules` is the module path, every block on its own module.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.stem import DW_DILATIONS
from ..ops.xchain import (TAIL_A, TAIL_B, entry_block_params,
                          fused_x_entry_block_train, fused_x_middle_train,
                          fused_x_tail_train, middle_train_params,
                          tail_train_params)
from ..ops.xchain_eval import (fused_x_entry_block_eval, fused_x_middle_eval,
                               fused_x_tail_eval)
from .layers import (BatchNorm, Conv2d, ConvBNReLU, SeparableConv2d,
                     update_bn_stats)


class SepConvBN(nn.Module):
    """relu (optional, before) -> separable conv (fixed padding, BN after
    the depthwise) -> BN -> relu (optional, after)."""

    def __init__(self, in_ch, out_ch, *, stride=1, dilation=1, pre_relu=True,
                 post_relu=False, dtype=None, generator=None):
        super().__init__()
        self.sep = SeparableConv2d(in_ch, out_ch, 3, stride=stride,
                                   dilation=dilation, bn_between=True,
                                   fixed_pad=True, dtype=dtype,
                                   generator=generator)
        self.bn = BatchNorm(out_ch)
        self.pre_relu = pre_relu
        self.post_relu = post_relu

    def forward(self, x):
        if self.pre_relu:
            x = F.relu(x)
        x = self.bn(self.sep(x))
        return F.relu(x) if self.post_relu else x


class XceptionBlock(nn.Module):
    """Three separable convs + residual skip (1x1 conv + BN if the shape
    changes)."""

    def __init__(self, in_ch, channels, *, stride=1, dilation=1,
                 first_relu=True, dtype=None, generator=None):
        super().__init__()
        c1, c2, c3 = channels
        kw = dict(dilation=dilation, dtype=dtype, generator=generator)
        self.sep1 = SepConvBN(in_ch, c1, pre_relu=first_relu, **kw)
        self.sep2 = SepConvBN(c1, c2, **kw)
        self.sep3 = SepConvBN(c2, c3, stride=stride, **kw)
        if stride != 1 or in_ch != c3:
            self.skip_conv = Conv2d(in_ch, c3, 1, stride=stride,
                                    use_bias=False, dtype=dtype,
                                    generator=generator)
            self.skip_bn = BatchNorm(c3)
        else:
            self.skip_conv = None
            self.skip_bn = None

    def forward(self, x):
        out = self.sep3(self.sep2(self.sep1(x)))
        skip = x if self.skip_conv is None else self.skip_bn(self.skip_conv(x))
        return out + skip


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()  # free for channels_last


def _nchw(y):
    return y.permute(0, 3, 1, 2)  # an NCHW view in channels_last memory


def _bn_ok(bn, c):
    """A train BN the train chains take."""
    return (isinstance(bn, BatchNorm) and bn.num_features == c and bn.affine
            and bn.track_running_stats and bn.training)


def _bn_eval_ok(bn, c):
    """An eval BN the eval chains fold: affine, on running statistics."""
    return (isinstance(bn, BatchNorm) and bn.num_features == c and bn.affine
            and bn.track_running_stats and not bn.training
            and bn.running_mean is not None)


def _sep_ok(s, cin, cout, stride, dil, bn_ok=_bn_ok):
    """A SepConvBN as the chains compute it: fixed-padding 3x3 depthwise at
    `stride` / dilation `dil` over cin channels, a BN that `bn_ok` takes,
    bias-free 1x1 cin -> cout, such a BN."""
    sep = getattr(s, "sep", None)
    if not isinstance(sep, SeparableConv2d) or not sep.fixed_pad:
        return False
    dw, pw = sep.depthwise, sep.pointwise
    return (isinstance(dw, Conv2d) and isinstance(pw, Conv2d)
            and tuple(dw.weight.shape) == (cin, 1, 3, 3)
            and dw.groups == cin and dw.stride == (stride, stride)
            and dw.dilation == (dil, dil) and dw.padding == (0, 0)
            and tuple(pw.weight.shape) == (cout, cin, 1, 1)
            and pw.stride == (1, 1) and pw.groups == 1
            and dw.bias is None and pw.bias is None
            and bn_ok(sep.bn_dw, cin) and bn_ok(s.bn, cout))


def _skip_ok(blk, cin, cout, stride, bn_ok=_bn_ok):
    c = blk.skip_conv
    return (isinstance(c, Conv2d) and c.bias is None
            and tuple(c.weight.shape) == (cout, cin, 1, 1)
            and c.stride == (stride, stride) and c.groups == 1
            and bn_ok(blk.skip_bn, cout))


def _seps_bns(seps):
    bns = []
    for s in seps:
        bns += [s.sep.bn_dw, s.bn]
    return bns


class Xception65(nn.Module):
    """Returns {'low_level': 128ch stride-4, 'out': 2048ch stride-OS}."""

    def __init__(self, *, output_stride: int = 16, dtype=None,
                 generator=None):
        super().__init__()
        if output_stride == 16:
            entry3_stride, exit_stride = 2, 1
            middle_dilation, exit_dilation = 1, 2
        elif output_stride == 8:
            entry3_stride, exit_stride = 1, 1
            middle_dilation, exit_dilation = 2, 4
        elif output_stride == 32:
            entry3_stride, exit_stride = 2, 2
            middle_dilation, exit_dilation = 1, 1
        else:
            raise ValueError(f"output_stride must be 8/16/32, got "
                             f"{output_stride}")
        kw = dict(dtype=dtype, generator=generator)
        self.conv1 = ConvBNReLU(3, 32, 3, stride=2, padding=1, **kw)
        self.conv2 = ConvBNReLU(32, 64, 3, padding=1, **kw)
        self.block1 = XceptionBlock(64, (128, 128, 128), stride=2,
                                    first_relu=False, **kw)
        self.block2 = XceptionBlock(128, (256, 256, 256), stride=2, **kw)
        self.block3 = XceptionBlock(256, (728, 728, 728),
                                    stride=entry3_stride, **kw)
        self.middle = nn.ModuleList([
            XceptionBlock(728, (728, 728, 728), dilation=middle_dilation,
                          **kw)
            for _ in range(16)])
        self.exit_block = XceptionBlock(728, (728, 1024, 1024),
                                        stride=exit_stride,
                                        dilation=exit_dilation, **kw)
        sep = dict(dilation=exit_dilation, pre_relu=False, post_relu=True,
                   **kw)
        self.exit_sep1 = SepConvBN(1024, 1536, **sep)
        self.exit_sep2 = SepConvBN(1536, 1536, **sep)
        self.exit_sep3 = SepConvBN(1536, 2048, **sep)
        self.low_level_channels = 128
        self.out_channels = 2048

    # -- the chains' guards ---------------------------------------------------

    def _eval_no_grad(self) -> bool:
        """Eval mode without autograd: where the forward-only eval chains
        run (as `ResNet._bneck_eval_active`)."""
        return not self.training and not torch.is_grad_enabled()

    @staticmethod
    def _entry_fits(blk, bn_ok) -> bool:
        """An entry block as the entry chains compute it (JAX
        `_fused_entry_ok`): dilation-1 seps, the third at stride 2, relu
        before the second and third, a 1x1/s2 skip with its BN, widths
        divisible by 8, every BN one that `bn_ok` takes."""
        try:
            cin = blk.sep1.sep.depthwise.in_channels
            c1 = blk.sep1.sep.pointwise.out_channels
            c2 = blk.sep2.sep.pointwise.out_channels
            c3 = blk.sep3.sep.pointwise.out_channels
            return (all(c % 8 == 0 for c in (cin, c1, c2, c3))
                    and _sep_ok(blk.sep1, cin, c1, 1, 1, bn_ok)
                    and _sep_ok(blk.sep2, c1, c2, 1, 1, bn_ok)
                    and _sep_ok(blk.sep3, c2, c3, 2, 1, bn_ok)
                    and blk.sep2.pre_relu and blk.sep3.pre_relu
                    and not any(s.post_relu for s in (blk.sep1, blk.sep2,
                                                      blk.sep3))
                    and _skip_ok(blk, cin, c3, 2, bn_ok))
        except AttributeError:
            return False

    def _middle_dilation(self, bn_ok):
        """The middle flow's dilation where the middle chains compute it
        (JAX `_fused_middle_mode`): a uniform dilation, plain residuals,
        relu before every sep, none after, every BN one that `bn_ok` takes;
        else None."""
        try:
            c = self.middle[0].sep1.sep.depthwise.in_channels
            d = self.middle[0].sep1.sep.depthwise.dilation[0]
            for blk in self.middle:
                if blk.skip_conv is not None:
                    return None
                for s in (blk.sep1, blk.sep2, blk.sep3):
                    if (not s.pre_relu or s.post_relu
                            or not _sep_ok(s, c, c, 1, d, bn_ok)):
                        return None
            return d
        except (AttributeError, IndexError):
            return None

    def _tail_dilation(self, bn_ok):
        """The exit flow's dilation where the tail chains compute it (JAX
        `_fused_tail_mode`): the TAIL_A / TAIL_B channel plan, stride 1
        with a uniform dilation >= 2 (OS16 and OS8; OS32's exit runs
        stride 2 on its modules), a 1x1 skip, relu before the exit block's
        seps and after the exit seps, every BN one that `bn_ok` takes; else
        None."""
        try:
            eb = self.exit_block
            seps = (self.exit_sep1, self.exit_sep2, self.exit_sep3)
            d = eb.sep1.sep.depthwise.dilation[0]
            if d < 2:
                return None
            ebs = (eb.sep1, eb.sep2, eb.sep3)
            # the specs' entry activations: relu before each exit-block sep;
            # no relu into exit_sep1, then each exit sep's relu after it
            for (ci, co, _), s in zip(TAIL_A + TAIL_B, ebs + seps):
                if not _sep_ok(s, ci, co, 1, d, bn_ok):
                    return None
            ok = (all(s.pre_relu and not s.post_relu for s in ebs)
                  and all(s.post_relu and not s.pre_relu for s in seps)
                  and _skip_ok(eb, TAIL_A[0][0], TAIL_A[2][1], 1, bn_ok))
            return d if ok else None
        except (AttributeError, IndexError):
            return None

    def _fused_entry_ok(self, blk) -> bool:
        """Train mode, and an entry block `fused_x_entry_block_train`
        takes."""
        return self.training and self._entry_fits(blk, _bn_ok)

    def _fused_middle_active(self) -> bool:
        """Train mode, and a middle flow `fused_x_middle_train` takes (a
        dilation the depthwise pass kernels take, DW_DILATIONS: 1 at OS16,
        2 at OS8, 1 at OS32)."""
        return (self.training
                and self._middle_dilation(_bn_ok) in DW_DILATIONS)

    def _fused_tail_active(self) -> bool:
        """Train mode, and an exit flow `fused_x_tail_train` takes (a
        dilation the depthwise pass kernels take, DW_DILATIONS: 2 at OS16,
        4 at OS8; OS32's stride-2 exit runs on its modules)."""
        return self.training and self._tail_dilation(_bn_ok) in DW_DILATIONS

    def _fused_entry_eval_ok(self, blk) -> bool:
        """Eval mode without autograd, and an entry block with eval BNs
        that `fused_x_entry_block_eval` takes."""
        return self._eval_no_grad() and self._entry_fits(blk, _bn_eval_ok)

    def _fused_middle_eval_active(self) -> bool:
        """Eval mode without autograd, and a middle flow with eval BNs that
        `fused_x_middle_eval` takes (any dilation, widths divisible by
        8)."""
        return (self._eval_no_grad()
                and self._middle_dilation(_bn_eval_ok) is not None
                and self.middle[0].sep1.sep.depthwise.in_channels % 8 == 0)

    def _fused_tail_eval_active(self) -> bool:
        """Eval mode without autograd, and an exit flow with eval BNs that
        `fused_x_tail_eval` takes (any dilation >= 2)."""
        return (self._eval_no_grad()
                and self._tail_dilation(_bn_eval_ok) is not None)

    # -- the chains -----------------------------------------------------------

    @staticmethod
    def _dtype(blk):
        return blk.sep1.sep.depthwise.compute_dtype

    def _call_fused_entry(self, x, blk):
        dt = self._dtype(blk)
        xin = _nhwc(x if dt is None else x.to(dt))
        act1 = "relu" if blk.sep1.pre_relu else False
        out, stats = fused_x_entry_block_train(
            xin, entry_block_params(blk), act1,
            float(blk.sep1.sep.bn_dw.eps))
        update_bn_stats(_seps_bns((blk.sep1, blk.sep2, blk.sep3))
                        + [blk.skip_bn], stats)
        return _nchw(out)

    def _call_fused_middle(self, x):
        m0 = self.middle[0]
        dt = self._dtype(m0)
        xin = _nhwc(x if dt is None else x.to(dt))
        out, stats = fused_x_middle_train(
            xin, middle_train_params(self.middle), len(self.middle),
            float(m0.sep1.sep.bn_dw.eps),
            int(m0.sep1.sep.depthwise.dilation[0]))
        bns = []
        for blk in self.middle:
            bns += _seps_bns((blk.sep1, blk.sep2, blk.sep3))
        update_bn_stats(bns, stats)
        return _nchw(out)

    def _call_fused_tail(self, x):
        eb = self.exit_block
        seps = (self.exit_sep1, self.exit_sep2, self.exit_sep3)
        dt = self._dtype(eb)
        xin = _nhwc(x if dt is None else x.to(dt))
        out, stats = fused_x_tail_train(
            xin, tail_train_params(eb, seps),
            int(eb.sep1.sep.depthwise.dilation[0]),
            float(eb.sep1.sep.bn_dw.eps))
        bns = (_seps_bns((eb.sep1, eb.sep2, eb.sep3)) + [eb.skip_bn]
               + _seps_bns(seps))
        update_bn_stats(bns, stats)
        return _nchw(out)

    def _call_fused_entry_eval(self, x, blk):
        dt = self._dtype(blk)
        return _nchw(fused_x_entry_block_eval(
            _nhwc(x if dt is None else x.to(dt)), blk))

    def _call_fused_middle_eval(self, x):
        m0 = self.middle[0]
        dt = self._dtype(m0)
        return _nchw(fused_x_middle_eval(
            _nhwc(x if dt is None else x.to(dt)), self.middle,
            int(m0.sep1.sep.depthwise.dilation[0])))

    def _call_fused_tail_eval(self, x):
        eb = self.exit_block
        dt = self._dtype(eb)
        return _nchw(fused_x_tail_eval(
            _nhwc(x if dt is None else x.to(dt)), eb,
            (self.exit_sep1, self.exit_sep2, self.exit_sep3),
            int(eb.sep1.sep.depthwise.dilation[0])))

    def _run_entry_block(self, x, blk):
        if self._fused_entry_ok(blk):
            return self._call_fused_entry(x, blk)
        if self._fused_entry_eval_ok(blk):
            return self._call_fused_entry_eval(x, blk)
        return blk(x)

    def _forward_modules(self, x):
        """The module path: every block on its own module."""
        x = self.conv2(self.conv1(x))
        x = self.block1(x)
        low_level = x
        x = self.block3(self.block2(x))
        for b in self.middle:
            x = b(x)
        x = self.exit_block(x)
        x = self.exit_sep3(self.exit_sep2(self.exit_sep1(x)))
        return {"low_level": low_level, "out": x}

    def forward(self, x):
        x = self.conv2(self.conv1(x))
        x = self._run_entry_block(x, self.block1)
        low_level = x
        x = self._run_entry_block(x, self.block2)
        x = self._run_entry_block(x, self.block3)
        if self._fused_middle_active():
            x = self._call_fused_middle(x)
        elif self._fused_middle_eval_active():
            x = self._call_fused_middle_eval(x)
        else:
            for b in self.middle:
                x = b(x)
        if self._fused_tail_active():
            x = self._call_fused_tail(x)
        elif self._fused_tail_eval_active():
            x = self._call_fused_tail_eval(x)
        else:
            x = self.exit_block(x)
            x = self.exit_sep3(self.exit_sep2(self.exit_sep1(x)))
        return {"low_level": low_level, "out": x}


def xception65(*, output_stride=16, dtype=None, generator=None) -> Xception65:
    return Xception65(output_stride=output_stride, dtype=dtype,
                      generator=generator)
