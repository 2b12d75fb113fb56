"""Eval-mode ResNet bottlenecks with every BN folded into its conv: the
teacher's layer1 and layer2[1:] (kd_cheap_conv_tpu/ops/pallas/rchain.py
`fused_resnet_blocks_eval` and rchain_hwnc.py `fused_resnet_stage_eval_hwnc`,
one computation in two TPU layouts, one kernel here).

    h1 = relu(x . W1 + b1)             1x1, C -> Cm
    h2 = relu(conv3x3(h1, W2) + b2)    stride 1, dilation 1, zero pad 1
    y  = relu(h2 . W3 + b3 + skip)     skip = x, or x . Wd + bd (1x1 / s1)

Rounding points, the JAX kernels': each BN's scale gamma * rsqrt(var + eps)
multiplies its conv's f32 weight in f32, and the product is cast to the
activation dtype (biases stay f32); the products take operands in the
activation dtype and sum in f32; h1 and h2 are rounded to the activation
dtype before the next product; the skip is added in f32; y is rounded once.

`run_bneck_eval(x_nhwc, blk)` launches csrc/rchain_eval.cu
`bneck_eval_kernel` on a CUDA tensor (or raises) and takes the plain
version, `bneck_eval_ref`, on a CPU tensor; it counts its launches in its
`launches` attribute. `fused_resnet_blocks_eval(x_nhwc, blocks)` runs
consecutive blocks, one launch each. Both take and return NHWC-contiguous
tensors (the memory of an NCHW channels_last tensor). Forward only.

`bneck_fusable` is the structural guard (JAX `_bneck_fusable`): a 3x3 /
stride 1 / dilation 1 / groups 1 conv between two bias-free 1x1 convs, a
downsample that is absent or a 1x1 / stride 1 conv, and widths divisible
by 8 (16-byte channel groups). The TPU gates are not carried over: the
input's C % 8 lane rule beside the guard (JAX resnet.py:165; here part of
the widths), the global batch % 8 (resnet.py:159) and Cm <= 128
(rchain_hwnc.py:52).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .stem import _DTYPE_CODE, _check_act, _pdt, _stream

# csrc/rchain_eval.cu: K chunks of 64 channels; a warp unit is one 16-row
# tile x 64 output channels; at most S1 / S2 / S3 units per warp (8 warps)
# in the 1x1, 3x3 and output phases; the per-CTA shared-memory limit
KC, UNIT_N, WARPS, S1, S2, S3 = 64, 64, 8, 3, 2, 2
SMEM_LIMIT = 232_448


def _conv_is(conv, k, stride=1, dilation=1) -> bool:
    return (conv.kernel_size == (k, k) and conv.stride == (stride, stride)
            and conv.dilation == (dilation, dilation) and conv.groups == 1
            and conv.bias is None
            and conv.padding == ((k // 2,) * 2 if k == 3 else (0, 0)))


def bneck_fusable(blk) -> bool:
    """The eval kernel's structural guard: 1x1 -> 3x3 (stride 1, dilation
    1, pad 1) -> 1x1 without conv biases, an absent or 1x1 / stride 1
    downsample, every width divisible by 8."""
    try:
        ds = blk.downsample
        widths = (blk.conv1.in_channels, blk.conv1.out_channels,
                  blk.conv3.out_channels)
        return (_conv_is(blk.conv1, 1) and _conv_is(blk.conv2, 3)
                and _conv_is(blk.conv3, 1)
                and (ds is None or _conv_is(ds.conv, 1))
                and (ds is not None or widths[0] == widths[2])
                and all(c % 8 == 0 for c in widths))
    except AttributeError:
        return False


def _bns(blk):
    return [blk.bn1, blk.bn2, blk.bn3] + (
        [blk.downsample.bn] if blk.downsample is not None else [])


def bns_eval(blk) -> bool:
    """Every BN of the block normalises with its running statistics."""
    return all(not bn.training and bn.track_running_stats
               and bn.running_mean is not None for bn in _bns(blk))


class FoldedBneck(NamedTuple):
    w1: torch.Tensor              # (Cm, C) activation dtype
    b1: torch.Tensor              # (Cm,) f32
    w2: torch.Tensor              # (9, Cm, Cm) [tap][out][in]
    b2: torch.Tensor
    w3: torch.Tensor              # (Co, Cm)
    b3: torch.Tensor              # (Co,)
    wd: torch.Tensor | None       # (Co, C)
    bd: torch.Tensor | None


def _fold_inputs(blk) -> list:
    convs = [blk.conv1, blk.conv2, blk.conv3] + (
        [blk.downsample.conv] if blk.downsample is not None else [])
    return [t for conv, bn in zip(convs, _bns(blk))
            for t in (conv.weight, bn.weight, bn.bias, bn.running_mean,
                      bn.running_var)]


def _bn_fold(bn, cdt):
    s = bn.weight.to(cdt) * torch.rsqrt(bn.running_var.to(cdt) + bn.eps)
    return s, (bn.bias.to(cdt) - bn.running_mean.to(cdt) * s).contiguous()


def fold_bneck_eval(blk, dtype) -> FoldedBneck:
    """The block's eval BNs folded into its convs (`_fold_bneck_eval`,
    `_fold_bneck`): weights scaled in f32 and cast to `dtype`, biases f32
    (f64 throughout for f64). Cached on the block until one of the tensors
    it reads is replaced, moved or updated in place (data pointers and
    version counters are the cache key)."""
    key = (dtype, *((t.data_ptr(), t._version) for t in _fold_inputs(blk)))
    hit = getattr(blk, "_kdcc_folded", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    cdt = _pdt(dtype)

    def w1x1(conv, bn):
        s, b = _bn_fold(bn, cdt)
        return (conv.weight.to(cdt)[:, :, 0, 0] * s[:, None]).to(
            dtype).contiguous(), b

    with torch.no_grad():
        w1, b1 = w1x1(blk.conv1, blk.bn1)
        s2, b2 = _bn_fold(blk.bn2, cdt)
        w2 = (blk.conv2.weight.to(cdt) * s2[:, None, None, None]).to(dtype)
        w2 = w2.permute(2, 3, 0, 1).reshape(9, *w2.shape[:2]).contiguous()
        w3, b3 = w1x1(blk.conv3, blk.bn3)
        wd = bd = None
        if blk.downsample is not None:
            wd, bd = w1x1(blk.downsample.conv, blk.downsample.bn)
        folded = FoldedBneck(w1, b1, w2, b2, w3, b3, wd, bd)
    blk._kdcc_folded = (key, folded)
    return folded


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def bneck_eval_ref(x_nhwc, blk):
    """Plain version of the kernel, from the same folded weights: products
    in f32 (f64 for f64 inputs) of operands in the activation dtype, h1 and
    h2 rounded to it, the skip added in f32, y rounded once. On the card the
    convolutions must run without TF32 (torch.backends.cudnn.allow_tf32 =
    False) to sum what the kernel sums."""
    dt = x_nhwc.dtype
    cdt = _pdt(dt)
    p = fold_bneck_eval(blk, dt)

    def conv(a, w, b, pad=0):
        return F.conv2d(a, w.to(cdt), b.to(cdt), padding=pad)

    x = x_nhwc.permute(0, 3, 1, 2).to(cdt)
    cm = p.w1.shape[0]
    h = torch.relu(conv(x, p.w1[:, :, None, None], p.b1)).to(dt).to(cdt)
    w2 = p.w2.reshape(3, 3, cm, cm).permute(2, 3, 0, 1)
    h = torch.relu(conv(h, w2, p.b2, 1)).to(dt).to(cdt)
    y = conv(h, p.w3[:, :, None, None], p.b3)
    skip = x if p.wd is None else conv(x, p.wd[:, :, None, None], p.bd)
    return torch.relu(y + skip).to(dt).permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# tiling (host side of the kernel)
# ---------------------------------------------------------------------------

def _r16(v):
    return (v + 15) // 16 * 16


def smem_bytes(th, tw, cm, nc, esize) -> int:
    """Dynamic shared memory of one CTA; the layout of smem_layout() in
    csrc/rchain_eval.cu, which checks that the two agree: h1 on the halo
    tile, h2 on the output tile (rows padded to 16, Cm padded to 16, +8
    elements a row), the staged A chunk and the staged weight chunk."""
    hpp, opp = _r16((th + 2) * (tw + 2)), _r16(th * tw)
    ld1, ldk = _r16(cm) + 8, KC + 8
    parts = (hpp * ld1, opp * ld1, max(hpp, opp) * ldk, max(cm, nc) * ldk)
    return sum(_r16(p * esize) for p in parts)


def _units(mt, channels):
    return mt * math.ceil(channels / UNIT_N)


@functools.lru_cache(maxsize=None)
def plan(h, w, c, cm, co, ds, esize) -> tuple[int, int, int, int]:
    """(th, tw, nc, smem) for one launch: the tile whose CTAs do the least
    padded work (MACs of the recomputed halo and the padded rows, and the
    weights each CTA stages, ~32 MACs an element) among those whose
    accumulators fit the warps' units and whose layout fits shared memory."""
    best = None
    for th in range(1, 17):
        for tw in range(2, 33):
            hpp, opp = _r16((th + 2) * (tw + 2)), _r16(th * tw)
            if (_units(hpp // 16, cm) > WARPS * S1
                    or _units(opp // 16, cm) > WARPS * S2):
                continue
            nc = min(co, UNIT_N * (WARPS * S3 // (opp // 16)))
            smem = smem_bytes(th, tw, cm, nc, esize)
            if nc < 8 or smem > SMEM_LIMIT:
                continue
            cp, cmp = _r16(c), _r16(cm)
            macs = (hpp * cp * cm
                    + opp * (9 * cmp * cm + cmp * co + ds * cp * co))
            weights = c * cm + 9 * cm * cm + cm * co + ds * c * co
            cost = math.ceil(h / th) * math.ceil(w / tw) * (macs
                                                             + 32 * weights)
            if best is None or cost < best[0]:
                best = (cost, (th, tw, nc, smem))
    if best is None:
        raise ValueError(f"no bottleneck tile fits: C {c}, Cm {cm}, Co {co}")
    return best[1]


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

def _launch(x, blk):
    from .. import native

    _check_act(x, "bneck_eval")
    n, h, w, c = x.shape
    p = fold_bneck_eval(blk, x.dtype)
    cm, co = p.w1.shape[0], p.w3.shape[0]
    if p.w1.shape[1] != c or p.w1.device != x.device:
        raise ValueError(f"bneck_eval: input (C {c}) on {x.device}, block "
                         f"takes C {p.w1.shape[1]} on {p.w1.device}")
    th, tw, nc, smem = plan(h, w, c, cm, co, int(p.wd is not None),
                            x.element_size())
    y = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
    err = native.library().kdcc_bneck_eval(
        _DTYPE_CODE[x.dtype], x.data_ptr(), p.w1.data_ptr(), p.b1.data_ptr(),
        p.w2.data_ptr(), p.b2.data_ptr(), p.w3.data_ptr(), p.b3.data_ptr(),
        None if p.wd is None else p.wd.data_ptr(),
        None if p.bd is None else p.bd.data_ptr(), y.data_ptr(), n, h, w, c,
        cm, co, th, tw, nc, smem, _stream(x))
    native.check(err, f"bneck_eval ({n},{h},{w},{c}) -> {cm} -> {co}")
    return y


def run_bneck_eval(x_nhwc, blk):
    """One eval bottleneck, NHWC in and out, in x's dtype: the kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if not bneck_fusable(blk) or not bns_eval(blk):
        raise ValueError("bneck_eval takes a 1x1 -> 3x3 / s1 / d1 -> 1x1 "
                         "bottleneck (widths % 8, an absent or 1x1 / s1 "
                         "downsample) with eval-mode BNs")
    if torch.is_grad_enabled() and (x_nhwc.requires_grad or any(
            t.requires_grad for t in blk.parameters())):
        raise RuntimeError("bneck_eval is forward-only: call it under "
                           "torch.no_grad() or inference_mode()")
    if x_nhwc.device.type == "cpu":
        return bneck_eval_ref(x_nhwc, blk)
    y = _launch(x_nhwc, blk)
    run_bneck_eval.launches += 1
    return y


run_bneck_eval.launches = 0
run_bneck_eval.layout_copies = 0


def fused_resnet_blocks_eval(x_nhwc, blocks):
    """Consecutive fusable bottlenecks in eval mode, one launch each (the
    JAX name): only each block's input and output touch device memory."""
    for blk in blocks:
        x_nhwc = run_bneck_eval(x_nhwc, blk)
    return x_nhwc
