"""Fused depthwise-separable conv (kd_cheap_conv_tpu/ops/pallas/separable.py).

y = pointwise(depthwise(x)) for a stride-1, 'same' pair (square odd k >= 3,
padding d (k - 1) / 2): the cheap-conv student's separable ASPP branches
and, in serving, its decoder fuse conv. On a CUDA tensor one launch of
csrc/head_convs.cu `spf::sep_conv_kernel` (bfloat16) or
`sep_fwd_f32_kernel` (float32) computes it, so the depthwise output never
reaches device memory; on a CPU tensor the plain version `separable_ref`
does. The backward is the JAX package's, in f32: the
depthwise output recomputed, dpw = mid^T g, dmid = g pw^T, dx the depthwise
of dmid with the flipped taps and ddw its weight gradient, the three
depthwise steps through ops.dwconv (csrc/resample_dw.cu on the card).

Layouts: x and y NHWC-contiguous (the port's channels_last memory); dw
(C, 1, k, k) and pw (Co, C, 1, 1), the port's OIHW weights, already in the
compute dtype (the caller casts, as the JAX module does). Numerics, the JAX
kernel's rule: the depthwise in f32 from the f32 taps, then the f32
intermediate times pw in f32, y rounded once. The kernel multiplies in f32
for float32; for bfloat16 it runs the product on the tensor cores as two
bf16 halves of the intermediate (hi + lo, pw is bf16 already), so the
product keeps ~16 of the intermediate's bits and y agrees with the plain
version to a last-bit rounding. The kernel takes C and Co divisible by 8
(16-byte channel groups) and k up to 7; the module's guard
(`kd.replace.AtrousSeparableConvolution`) asks for them.

`launch_sep_fwd` is shared with the decoder head's first pass
(ops/decoder.py `run_sep_fwd`; bfloat16: `spf::sep_fwd_kernel`): two
inputs, the channels of the second after the first's, and the batch mean
and variance of the f32 output, summed in the kernel (that pass rounds the
intermediate to bfloat16 for its product, as the JAX `_k_sep_fwd` does).
The kernel's plan (grid, scratch, tickets) is the library's
(`sep_fwd_plan`).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .dwconv import dw_weight_taps, run_dw_conv, run_dw_dk, run_dw_dx
from .stem import (_DTYPE_CODE, _check_act, _need, _pdt, _scratch, _stream,
                   _tickets)

# the widest depthwise kernel sep_fwd takes (csrc/head_convs.cu kMaxK)
SEP_MAX_K = 7


def supports_fused_separable(*, stride, padding, dilation, kernel_size) -> bool:
    """Stride 1, square odd k >= 3 and p = d (k - 1) / 2 (separable.py:39),
    with every per-axis value equal (the JAX check reads the first)."""
    def pair(v):
        return tuple(v) if isinstance(v, (tuple, list)) else (v, v)

    (s, s2), (p, p2), (d, d2), (k, k2) = (pair(v) for v in (
        stride, padding, dilation, kernel_size))
    return (s == s2 == 1 and k == k2 and k >= 3 and k % 2 == 1 and d == d2
            and p == p2 == d * (k - 1) // 2)


def separable_ref(x, dw, pw, dilation):
    """Plain version: the depthwise and the pointwise product in f32 (f64
    for f64 inputs), y in x's dtype."""
    cdt = _pdt(x.dtype)
    c, k = dw.shape[0], dw.shape[-1]
    p = dilation * (k - 1) // 2
    mid = F.conv2d(x.to(cdt).permute(0, 3, 1, 2), dw.to(cdt), None, 1, p,
                   dilation, c).permute(0, 2, 3, 1)
    y = mid @ pw.to(cdt).reshape(pw.shape[0], c).t()
    return y.to(x.dtype).contiguous()


@functools.lru_cache(maxsize=None)
def sep_fwd_plan(dtype, n, h, w, c0, c1, co, k, dilation, moments):
    """sep_fwd's (CTAs, f32 scratch floats, tickets) for a shape, as
    csrc/head_convs.cu kdcc_sep_fwd_plan gives them (asked once per shape;
    the kernel refuses another grid or scratch size): the scratch and
    tickets hold the moments' sums and, in bfloat16, the partial sums of
    items that two CTAs share. Raises for a shape it does not take."""
    from .. import native

    lib = native.library()
    plan = tuple(lib.kdcc_sep_fwd_plan(what, _DTYPE_CODE[dtype], n, h, w, c0,
                                       c1, co, k, dilation, int(moments))
                 for what in range(3))
    if plan[0] < 1:
        raise ValueError(f"sep_fwd takes no ({n},{h},{w},{c0}+{c1}) -> {co} "
                         f"k{k} d{dilation}{' with moments' if moments else ''}")
    return plan


SEP_FWD = "sep_fwd"


def launch_sep_fwd(x0, x1, dwt, pw, k, dilation, moments):
    """One sep_fwd launch on x0 (N, H, W, C0) and x1 (N, H, W, C1) or None:
    taps dwt (k * k, C0 + C1) f32, pw (Co, C0 + C1) in x0's dtype. Returns
    (y, [mean, biased variance] (2, Co) of the f32 y, summed in the kernel,
    or None)."""
    from .. import native

    _check_act(x0, "sep_fwd")
    n, h, w, c0 = x0.shape
    c1 = 0 if x1 is None else x1.shape[-1]
    if x1 is not None:
        _need(x1, "x1", (n, h, w, c1), x0.dtype, x0.device)
    ci, co, dev = c0 + c1, pw.shape[0], x0.device
    _need(dwt, "dwt", (k * k, ci), torch.float32, dev)
    _need(pw, "pw", (co, ci), x0.dtype, dev)
    if (c0 % 8 or c1 % 8 or co % 8 or k % 2 == 0 or not 3 <= k <= SEP_MAX_K
            or any(t is not None and t.data_ptr() % 16
                   for t in (x0, x1, dwt, pw))):
        raise ValueError(f"sep_fwd takes channel counts divisible by 8 and "
                         f"16-byte aligned tensors, odd k up to {SEP_MAX_K}; "
                         f"got {c0} + {c1} -> {co}, k {k}")
    grid, floats, tickets = sep_fwd_plan(x0.dtype, n, h, w, c0, c1, co, k,
                                         dilation, moments)
    y = torch.empty((n, h, w, co), dtype=x0.dtype, device=dev)
    mv = (torch.empty((2, co), dtype=torch.float32, device=dev)
          if moments else None)
    err = native.library().kdcc_sep_fwd(
        _DTYPE_CODE[x0.dtype], x0.data_ptr(),
        None if x1 is None else x1.data_ptr(), dwt.data_ptr(), pw.data_ptr(),
        y.data_ptr(), None if mv is None else mv.data_ptr(),
        _scratch(dev, SEP_FWD, floats).data_ptr() if floats else None,
        _tickets(dev, SEP_FWD, tickets).data_ptr() if floats else None,
        n, h, w, c0, c1, co, k, dilation, grid, floats, _stream(x0))
    if err:
        native.check(err, f"sep_fwd ({n},{h},{w},{c0}+{c1}) -> {co} k{k} "
                          f"d{dilation}")
    return y, mv


def run_separable(x, dw, pw, dilation):
    """y = pointwise(depthwise(x)): x NHWC, dw (C, 1, k, k), pw (Co, C, 1,
    1), stride 1, dilation `dilation`, 'same' padding."""
    if x.device.type == "cpu":
        return separable_ref(x, dw, pw, dilation)
    y, _ = launch_sep_fwd(x, None, dw_weight_taps(dw),
                          pw.reshape(pw.shape[0], -1).to(x.dtype).contiguous(),
                          dw.shape[-1], dilation, False)
    run_separable.launches += 1
    return y


run_separable.launches = 0


class _FusedSeparable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dw, pw, dilation):
        ctx.dilation = dilation
        ctx.save_for_backward(x, dw, pw)
        return run_separable(x, dw, pw, dilation)

    @staticmethod
    def backward(ctx, g):
        """separable.py:143-176 in f32 (f64 for f64): the depthwise output
        recomputed and dx as the depthwise of dmid with the flipped taps,
        both through ops.dwconv's conv (the JAX rule's `depthwise_conv2d`,
        which the JAX package's dispatch sends to its Pallas kernel), ddw
        through its weight-gradient kernel, dpw = mid^T g."""
        x, dw, pw = ctx.saved_tensors
        cdt = _pdt(x.dtype)
        c, k, co = dw.shape[0], dw.shape[-1], pw.shape[0]
        d = ctx.dilation
        taps = dw_weight_taps(dw)
        xs = x.to(cdt)
        mid = run_dw_conv(xs, taps, k, d)
        g2 = g.to(cdt).reshape(-1, co)
        dmid = (g2 @ pw.to(cdt).reshape(co, c)).reshape(xs.shape)
        dx = run_dw_dx(dmid, taps, k, d)
        ddw = run_dw_dk(xs, dmid, k, d).t().reshape(dw.shape)
        dpw = (g2.t() @ mid.reshape(-1, c)).reshape(pw.shape)
        return (dx.to(x.dtype), ddw.to(dw.dtype), dpw.to(pw.dtype), None)


def fused_separable_conv(x, dw, pw, dilation: int = 1):
    """y = pointwise(depthwise(x)), x NHWC (N, H, W, C) -> y NHWC (N, H, W,
    Co); dw (C, 1, k, k), pw (Co, C, 1, 1) in x's dtype. Gradients reach x,
    dw and pw (the depthwise output recomputed)."""
    return _FusedSeparable.apply(x.contiguous(), dw, pw, int(dilation))
