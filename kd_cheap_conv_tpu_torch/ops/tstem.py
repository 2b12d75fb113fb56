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

# csrc/entry_convs.cu: a tile is TPH x TPW pooled outputs; grid-stride over
# at most GRID CTAs (two per SM: the weights are staged once per CTA)
CO, TPH, TPW, GRID = 64, 4, 16, 264
_K, _CR, _CCP = 147, 2 * TPH + 1, 36
_XS = (2 * (_CR - 1) + 7) * (2 * (_CCP - 1) + 7) * 3


def smem_bytes(esize: int) -> int:
    """Dynamic shared memory of the kernel (the .cu checks it): weights,
    shift, the image window (16-byte padded) and the conv tile."""
    return 4 * (_K * CO + CO + (_XS + 3) // 4 * 4) + esize * _CR * _CCP * CO


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
    w, shift = fold_stem(conv, bn, x.dtype)
    _need(w, "folded weight", (CO, _K), x.dtype, x.device)
    _need(shift, "shift", (CO,), torch.float32, x.device)
    hc, wc = (h + 1) // 2, (wd + 1) // 2
    ho, wo = (hc + 1) // 2, (wc + 1) // 2
    grid = min(n * math.ceil(ho / TPH) * math.ceil(wo / TPW), GRID)
    y = torch.empty((n, ho, wo, CO), dtype=x.dtype, device=x.device)
    err = native.library().kdcc_tstem(
        _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), shift.data_ptr(),
        y.data_ptr(), n, h, wd, grid, smem_bytes(x.element_size()),
        _stream(x))
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
