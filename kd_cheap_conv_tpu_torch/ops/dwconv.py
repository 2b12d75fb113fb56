"""Depthwise conv, stride 1, 'same' padding, any dilation, with its backward
(kd_cheap_conv_tpu/ops/pallas/dwconv.py and dwhwnc.py: one computation in
two TPU layouts, one kernel family here).

On a CUDA tensor csrc/resample_dw.cu computes it: `dw_conv_kernel` the
forward (`run_dw_conv`) and, with the taps flipped, the input gradient
(`run_dw_dx`); `dw_dk_kernel` the weight gradient as CTA partials that
`run_dw_dk` sums in a fixed order. On a CPU tensor the plain versions
`depthwise_conv2d_ref`, `depthwise_dx_ref` and `depthwise_dk_ref` do. Each
wrapper counts its launches in its `launches` attribute.

Layouts: activations NHWC-contiguous (the port's channels_last memory),
taps (k * k, C) float32 in row-major tap order (the JAX `kr` transposed).
Numerics, the JAX kernels' (`_taps_win`, `_k_dw_dk`): inputs and taps
widened to f32, the taps summed in row-major order in f32 (f64 for f64
inputs, which only the plain versions take), rounded once to the
activation dtype; dk summed in f32. The plain versions take the same
products and sums as the conv kernel, which matches them bit for bit; dk's
sums run in another order.

`depthwise_conv2d(x, w, dilation)` is the autograd Function the port's
`Conv2d` calls for an NCHW x (channels_last memory reads without a copy;
another layout is copied, and counted in `depthwise_conv2d.layout_copies`,
as is a gradient that arrives in another layout). Its weight gradient
leaves in w's dtype, as the JAX rule rounds dk to the taps' dtype
(dwconv.py:259).

`supports_depthwise` is the structural guard (the JAX `supports_pallas_dw`,
dwconv.py:45): stride 1, a square odd kernel k >= 3, padding d (k - 1) / 2,
groups == C_in == C_out; for the kernels, k <= 7 and C % 8 == 0 (16-byte
channel groups). The TPU gates (N % 8, the halo amplification limit, the
VMEM row tile, a 2-byte itemsize) are not carried over.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .stem import _DTYPE_CODE, _check_act, _need, _pdt, _stream

DW_MAX_K = 7
DW_DTYPES = (torch.float32, torch.bfloat16)


def supports_depthwise(*, stride, padding, dilation, kernel_size, groups,
                       in_channels, out_channels) -> bool:
    def pair(v):
        return tuple(v) if isinstance(v, (tuple, list)) else (v, v)

    (s, s2), (p, p2), (d, d2), (k, k2) = (pair(v) for v in (
        stride, padding, dilation, kernel_size))
    return (s == s2 == 1 and k == k2 and 3 <= k <= DW_MAX_K and k % 2 == 1
            and d == d2 >= 1 and p == p2 == d * (k - 1) // 2
            and groups == in_channels == out_channels
            and in_channels % 8 == 0)


def dw_weight_taps(w):
    """(C, 1, k, k) weight -> (k * k, C) taps, f32 (f64 for f64)."""
    c, k = w.shape[0], w.shape[-1]
    return w.to(_pdt(w.dtype)).reshape(c, k * k).t().contiguous()


def _tap_sum(x, taps, k, dilation, flip):
    cdt = _pdt(x.dtype)
    h, w = x.shape[1:3]
    p = dilation * (k - 1) // 2
    xp = F.pad(x.to(cdt), (0, 0, p, p, p, p))
    taps = taps.to(cdt)
    acc = torch.zeros(x.shape, dtype=cdt, device=x.device)
    for t in range(k * k):
        i, j = divmod(t, k)
        kt = taps[k * k - 1 - t] if flip else taps[t]
        acc = acc + xp[:, i * dilation:i * dilation + h,
                       j * dilation:j * dilation + w] * kt
    return acc.to(x.dtype)


def depthwise_conv2d_ref(x, taps, k, dilation):
    """Plain version: x (N, H, W, C), taps (k * k, C) -> (N, H, W, C) in
    x's dtype."""
    return _tap_sum(x, taps, k, dilation, False)


def depthwise_dx_ref(g, taps, k, dilation):
    """Plain input gradient: the conv of g with the flipped taps (tap t
    reads taps[k * k - 1 - t])."""
    return _tap_sum(g, taps, k, dilation, True)


def depthwise_dk_ref(x, g, k, dilation):
    """Plain weight gradient: dk (k * k, C), dk[t] = sum x[tap t] * g, f32
    (f64 for f64)."""
    cdt = _pdt(x.dtype)
    h, w = x.shape[1:3]
    p = dilation * (k - 1) // 2
    xp = F.pad(x.to(cdt), (0, 0, p, p, p, p))
    gf = g.to(cdt)
    return torch.stack([
        (xp[:, i * dilation:i * dilation + h, j * dilation:j * dilation + w]
         * gf).sum((0, 1, 2))
        for i in range(k) for j in range(k)])


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check_dw(x, taps, k, dilation, what):
    _check_act(x, what)
    c = x.shape[-1]
    _need(taps, "taps", (k * k, c), torch.float32, x.device)
    if c % 8 or k % 2 == 0 or not 3 <= k <= DW_MAX_K or dilation < 1:
        raise ValueError(f"{what} takes C divisible by 8, odd k from 3 to "
                         f"{DW_MAX_K} and a dilation >= 1; got C {c}, k {k}, "
                         f"dilation {dilation}")


def _launch_dw_conv(x, taps, k, dilation, flip):
    from .. import native

    what = "dw_dx" if flip else "dw_conv"
    _check_dw(x, taps, k, dilation, what)
    n, h, w, c = x.shape
    y = torch.empty_like(x)
    err = native.library().kdcc_dw_conv(
        _DTYPE_CODE[x.dtype], x.data_ptr(), taps.data_ptr(), y.data_ptr(), n,
        h, w, c, k, dilation, int(flip), _stream(x))
    native.check(err, f"{what} ({n},{h},{w},{c}) k{k} d{dilation}")
    return y


def run_dw_conv(x, taps, k, dilation):
    """Depthwise conv of x (N, H, W, C) with taps (k * k, C)."""
    if x.device.type == "cpu":
        return depthwise_conv2d_ref(x, taps, k, dilation)
    y = _launch_dw_conv(x, taps, k, dilation, False)
    run_dw_conv.launches += 1
    return y


def run_dw_dx(g, taps, k, dilation):
    """Input gradient of the depthwise conv: g conv the flipped taps."""
    if g.device.type == "cpu":
        return depthwise_dx_ref(g, taps, k, dilation)
    y = _launch_dw_conv(g, taps, k, dilation, True)
    run_dw_dx.launches += 1
    return y


def run_dw_dk(x, g, k, dilation):
    """Weight gradient (k * k, C) f32 from x and g (N, H, W, C)."""
    if x.device.type == "cpu":
        return depthwise_dk_ref(x, g, k, dilation)
    from .. import native

    n, h, w, c = x.shape
    _check_dw(x, None, k, dilation, "dw_dk")
    _need(g, "g", x.shape, x.dtype, x.device)
    lib = native.library()
    grid = lib.kdcc_dw_dk_grid(n, h, w)
    part = torch.empty((grid, k * k, c), dtype=torch.float32, device=x.device)
    err = lib.kdcc_dw_dk(_DTYPE_CODE[x.dtype], x.data_ptr(), g.data_ptr(),
                         part.data_ptr(), n, h, w, c, k, dilation, grid,
                         _stream(x))
    native.check(err, f"dw_dk ({n},{h},{w},{c}) k{k} d{dilation}")
    run_dw_dk.launches += 1
    return part.sum(0)


run_dw_conv.launches = run_dw_dx.launches = run_dw_dk.launches = 0
KERNELS = (run_dw_conv, run_dw_dx, run_dw_dk)


def _nhwc(t):
    """An NCHW tensor's NHWC-contiguous form: a view in channels_last
    memory, else a copy (counted)."""
    if not t.is_contiguous(memory_format=torch.channels_last):
        depthwise_conv2d.layout_copies += 1
    return t.permute(0, 2, 3, 1).contiguous()


class _Depthwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, dilation):
        k = w.shape[-1]
        taps = dw_weight_taps(w)
        xh = _nhwc(x)
        ctx.save_for_backward(xh, taps)
        ctx.k, ctx.dilation, ctx.w_dtype = k, dilation, w.dtype
        return run_dw_conv(xh, taps, k, dilation).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        xh, taps = ctx.saved_tensors
        k, d = ctx.k, ctx.dilation
        gh = _nhwc(g)
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = run_dw_dx(gh, taps, k, d).permute(0, 3, 1, 2)
        if ctx.needs_input_grad[1]:
            c = taps.shape[1]
            dk = run_dw_dk(xh, gh, k, d).t().reshape(c, 1, k, k).to(ctx.w_dtype)
        return dx, dk, None


def depthwise_conv2d(x, w, dilation: int = 1):
    """Depthwise conv of x (N, C, H, W) with w (C, 1, k, k) in x's dtype,
    stride 1, padding dilation (k - 1) / 2; returns an NCHW view in
    channels_last memory. The guard is the caller's (`supports_depthwise`)."""
    return _Depthwise.apply(x, w, int(dilation))


depthwise_conv2d.layout_copies = 0
