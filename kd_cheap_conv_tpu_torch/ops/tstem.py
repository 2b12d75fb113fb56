"""Fused eval-mode ResNet stem: conv 7x7 / stride 2 / pad 3 + eval BN + relu
+ maxpool 3x3 / stride 2 / pad 1, as one forward-only kernel.

Counterpart of kd_cheap_conv_tpu/ops/pallas/tstem.py
(`fused_stem_pool_eval_nhcw`). The JAX kernel reads the host-packed
space-to-depth image (a TPU layout); this one reads the NHWC image that the
loader delivers, with the stride in its index (csrc/entry_convs.cu,
`tstem_kernel`). The eval BN folds into the conv as the JAX package folds it
(`_w0_from_conv`): scale = gamma * rsqrt(var + eps), shift = beta - mean *
scale, the weight cast to the activation dtype, scaled in f32 and cast again;
the conv sums in f32, adds the shift, takes the relu and the max over the
pool window, whose padding is -inf as in `F.max_pool2d`. Output
(N, (Hc + 1) // 2, (Wc + 1) // 2, 64) NHWC with Hc = (H + 1) // 2.

In bf16 (the main path) the kernel is an implicit GEMM on the tensor cores
(`tsm::tstem_kernel`): space-to-depth in shared memory makes the stride-2
7x7 a stride-1 4x4 over 12 channels, padded to 16, so each s2d tap is one
k16 step of mma.sync (K = 256, N = 64); it reads the folded weight in the
fragment layout `stem_frag` builds (cached beside the fold), tiles of at
most TPH x TPW pooled outputs split evenly over the image (`bf16_tiles`),
and a shared-memory layout `bf16_smem_bytes` mirrors. In f32 (parity only)
the CUDA-core kernel reads the folded weight as (64, 147).

`fused_stem_pool_eval(x_nhwc, conv, bn)` launches the kernel on a CUDA tensor
(or raises) and takes the plain version, `fused_stem_pool_eval_ref`, on a CPU
tensor; it counts its launches in its `launches` attribute.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .foldcache import cached_fold
from .stem import _DTYPE_CODE, _check_act, _need, _pdt, _stream

# csrc/entry_convs.cu: a tile is at most TPH x TPW pooled outputs; grid-stride
# over at most GRID CTAs (two per SM: the weights are staged once per CTA)
CO, TPH, TPW, GRID = 64, 4, 16, 264
_K, _CR, _CCP = 147, 2 * TPH + 1, 36
_XS = (2 * (_CR - 1) + 7) * (2 * (_CCP - 1) + 7) * 3


def smem_bytes(esize: int) -> int:
    """Dynamic shared memory of the f32 kernel (the .cu checks it): weights,
    shift, the image window (16-byte padded) and the conv tile."""
    return 4 * (_K * CO + CO + (_XS + 3) // 4 * 4) + esize * _CR * _CCP * CO


# the bf16 kernel (tsm::): the s2d tile is (conv rows + 3) x (conv columns +
# 3) pixels of 16 channels, its raw image rows arrive 448 bytes a row (6 x
# 72 bytes and the 16-byte alignment) in two stages, the conv tile is
# [pixel][64] bf16
S2D_CH = 16
FRAG_VALUES = 16 * 4 * 32 * 8        # [tap][n16 pair][lane][8]
_CC = 2 * TPW + 1
_RAW_ROW = 448


def bf16_smem_bytes() -> int:
    """Dynamic shared memory of the bf16 kernel (the .cu checks it): the
    fragment-layout weights, the shift, the s2d tile, the conv tile and two
    raw stages of image rows."""
    s2d = (_CR + 3) * (_CC + 3) * S2D_CH * 2
    return (FRAG_VALUES * 2 + CO * 4 + s2d + _CR * _CC * CO * 2
            + 2 * 2 * (_CR + 3) * _RAW_ROW)


_BF16_SMEM = bf16_smem_bytes()


def _split(total, parts, i):
    """[start, end) of part i of `total` split into `parts` near-equal runs."""
    return i * total // parts, (i + 1) * total // parts


def bf16_tiles(n, h, w):
    """The bf16 kernel's tiles of an (n, h, w, 3) image (mirrors
    tsm::tiles_of / tile_at): [(image, pooled row start, rows, pooled column
    start, columns)], the pooled rows split evenly into ceil(Ho / TPH) runs
    and the columns into ceil(Wo / TPW), in the kernel's tile order."""
    ho, wo = ((h + 1) // 2 + 1) // 2, ((w + 1) // 2 + 1) // 2
    nrt, nct = -(-ho // TPH), -(-wo // TPW)
    out = []
    for img in range(n):
        for i in range(nrt):
            r0, r1 = _split(ho, nrt, i)
            for j in range(nct):
                c0, c1 = _split(wo, nct, j)
                out.append((img, r0, r1 - r0, c0, c1 - c0))
    return out


def _frag_index():
    """(16, 4, 32, 8) indices into the folded weight (64, 147) flattened
    with a zero appended (index 64 * 147): value q of lane l at tap s =
    (dR, dC) and n16 pair jp is mma.m16n8k16's B fragment element for
    n = 8 (2 jp + q // 4) + l // 4, k = 2 (l % 4) + q % 2 + 8 ((q // 2) % 2),
    s2d channel k = a * 6 + b * 3 + ci (k >= 12 zero) of image tap
    (dh, dw) = (2 dR + a, 2 dC + b) (7 zero)."""
    idx = torch.full((16, 4, 32, 8), CO * _K, dtype=torch.long)
    for s in range(16):
        dr, dc = divmod(s, 4)
        for jp in range(4):
            for lane in range(32):
                for q in range(8):
                    nn = 8 * (2 * jp + q // 4) + lane // 4
                    k = 2 * (lane % 4) + q % 2 + 8 * ((q // 2) % 2)
                    if k >= 12:
                        continue
                    a, b, ci = k // 6, (k % 6) // 3, k % 3
                    dh, dw = 2 * dr + a, 2 * dc + b
                    if dh < 7 and dw < 7:
                        idx[s, jp, lane, q] = nn * _K + (dh * 7 + dw) * 3 + ci
    return idx


_FRAG_INDEX = None


def stem_frag(w):
    """The folded weight (64, 147) in the bf16 kernel's fragment layout:
    (FRAG_VALUES,) in w's dtype, each weight once, zeros elsewhere
    (`_frag_index`)."""
    global _FRAG_INDEX
    if _FRAG_INDEX is None:
        _FRAG_INDEX = _frag_index().reshape(-1)
    flat = torch.cat([w.reshape(-1), w.new_zeros(1)])
    return flat[_FRAG_INDEX.to(w.device)].contiguous()


def fold_stem_frag(conv, bn):
    """(`stem_frag` of the bf16 fold, shift): the bf16 kernel's operands,
    cached on the conv beside the fold."""
    def build():
        w, shift = fold_stem(conv, bn, torch.bfloat16)
        return stem_frag(w), shift

    return cached_fold(conv, "_kdcc_folded_frag",
                       (conv.weight, bn.weight, bn.bias, bn.running_mean,
                        bn.running_var), torch.bfloat16, build)


def stem_pool_eval_fusable(conv, bn) -> bool:
    """conv 7x7 / stride 2 / pad 3, 3 -> 64, no bias, then an affine
    BatchNorm in eval mode with running statistics."""
    try:
        return (tuple(conv.weight.shape) == (CO, 3, 7, 7)
                and conv.stride == (2, 2) and conv.padding == (3, 3)
                and conv.dilation == (1, 1) and conv.groups == 1
                and conv.bias is None and isinstance(bn, torch.nn.BatchNorm2d)
                and bn.num_features == CO and bn.affine
                and bn.track_running_stats and not bn.training)
    except AttributeError:
        return False


def fold_stem(conv, bn, dtype):
    """(weight (64, 147) in `dtype`, taps ordered (dh, dw, ci), shift (64,)
    f32): the eval BN folded into the conv. Cached on the conv
    (ops/foldcache.py)."""
    def build():
        s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        shift = (bn.bias.float() - bn.running_mean.float() * s).contiguous()
        w = (conv.weight.to(dtype).float() * s[:, None, None, None]).to(dtype)
        return (w.permute(0, 2, 3, 1).reshape(CO, _K).contiguous(), shift)

    return cached_fold(conv, "_kdcc_folded",
                       (conv.weight, bn.weight, bn.bias, bn.running_mean,
                        bn.running_var), dtype, build)


def fused_stem_pool_eval_ref(x_nhwc, conv, bn):
    """Plain version: the folded conv, relu and max_pool2d in f32 (f64 for
    f64 inputs), from the same folded weight the kernel reads."""
    w, shift = fold_stem(conv, bn, x_nhwc.dtype)
    cdt = _pdt(x_nhwc.dtype)
    wk = w.to(cdt).reshape(CO, 7, 7, 3).permute(0, 3, 1, 2)
    h = F.conv2d(x_nhwc.to(cdt).permute(0, 3, 1, 2), wk, None, 2, 3)
    h = torch.relu(h + shift.to(cdt)[:, None, None])
    y = F.max_pool2d(h, 3, 2, 1)
    return y.permute(0, 2, 3, 1).to(x_nhwc.dtype).contiguous()


def _launch(x, conv, bn):
    from .. import native

    _check_act(x, "fused_stem_pool_eval")
    n, h, wd, ci = x.shape
    if ci != 3:
        raise ValueError(f"fused_stem_pool_eval takes a 3-channel image, got "
                         f"{ci} channels")
    if x.dtype == torch.bfloat16:
        if x.data_ptr() % 16:
            raise ValueError("fused_stem_pool_eval copies 16 bytes at a time: "
                             "a bf16 image must be 16-byte aligned")
        w, shift = fold_stem_frag(conv, bn)
        _need(w, "weight fragments", (FRAG_VALUES,), x.dtype, x.device)
        smem = _BF16_SMEM
    else:
        w, shift = fold_stem(conv, bn, x.dtype)
        _need(w, "folded weight", (CO, _K), x.dtype, x.device)
        smem = smem_bytes(x.element_size())
    _need(shift, "shift", (CO,), torch.float32, x.device)
    hc, wc = (h + 1) // 2, (wd + 1) // 2
    ho, wo = (hc + 1) // 2, (wc + 1) // 2
    grid = min(n * math.ceil(ho / TPH) * math.ceil(wo / TPW), GRID)
    y = torch.empty((n, ho, wo, CO), dtype=x.dtype, device=x.device)
    err = native.library().kdcc_tstem(
        _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), shift.data_ptr(),
        y.data_ptr(), n, h, wd, grid, smem, _stream(x))
    native.check(err, f"tstem ({n},{h},{wd},3)")
    return y


def fused_stem_pool_eval(x_nhwc, conv, bn):
    """relu(BN_eval(conv7x7s2(x))) max-pooled 3x3/s2, NHWC in and out, in
    x's dtype (the conv's compute dtype). Forward only."""
    if not stem_pool_eval_fusable(conv, bn):
        raise ValueError("fused_stem_pool_eval takes conv 7x7 / stride 2 / "
                         "pad 3, 3 -> 64 without bias and an eval-mode BN")
    if torch.is_grad_enabled() and (x_nhwc.requires_grad or any(
            t.requires_grad for t in (conv.weight, bn.weight, bn.bias))):
        raise RuntimeError("fused_stem_pool_eval is forward-only: call it "
                           "under torch.no_grad() or inference_mode()")
    if x_nhwc.device.type == "cpu":
        return fused_stem_pool_eval_ref(x_nhwc, conv, bn)
    y = _launch(x_nhwc, conv, bn)
    fused_stem_pool_eval.launches += 1
    return y


fused_stem_pool_eval.launches = 0
