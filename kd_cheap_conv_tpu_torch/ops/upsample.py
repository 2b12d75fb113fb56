"""The decoder's bilinear upsample (kd_cheap_conv_tpu/ops/pallas/upsample.py).

`resize_bilinear_up(x, size)` upsamples an NHWC tensor (or, with
layout="NCHW", an NCHW tensor in channels_last memory) with half-pixel
centres (align_corners=False, no antialias): the decoder's 4x resize of the
ASPP output, 33² -> 129² at config #2. On a CUDA tensor one launch of
csrc/resample_dw.cu `up_fwd_kernel` computes it and one of `up_bwd_kernel`
its gradient, the transposed interpolation in gather form; on a CPU tensor
the plain versions `resize_bilinear_up_ref` and `resize_bilinear_up_bwd_ref`
do. Each wrapper counts its launches in its `launches` attribute.

Interpolation tables are built on the host as the JAX package's
`_halfpix_np` builds its matrix (float64 positions, float32 weights, the two
taps of a clipped edge summed), one per (n_in, n_out), and cached on each
device. Forward, per output index: two (input index, weight) taps. Backward,
per input index: the list of (output index, weight) it feeds, padded to the
widest list with (-1, 0).

Numerics, the JAX kernel's rounding points (`_k_up_fwd`, `_k_up_bwd` and
stem.py's `_mm`): forward, z = H-interpolation of x with f32 weights in
f32, rounded to x's dtype; y = W-interpolation of z with the weights
rounded to x's dtype, in f32, rounded once. Backward, u = W-transpose of g
with weights in g's dtype, f32, not rounded; gx = H-transpose of u with f32
weights, f32, rounded once. The plain versions round at the same points and
take the same products and sums, so the kernels match them bit for bit.

`supports_upsample` is the structural guard: 4-D, a genuine upsample (Ho >=
Hi, Wo >= Wi, not the identity), float32 or bfloat16, and channels in
16-byte groups (C % 8 == 0, the kernels' vector width). The TPU kernel's
C % 128 lane rule and VMEM window are not carried over.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .stem import _DTYPE_CODE, _check_act, _pdt, _stream

UP_DTYPES = (torch.float32, torch.bfloat16)


def supports_upsample(shape, size, dtype) -> bool:
    if len(shape) != 4:
        return False
    _, hi, wi, c = shape
    ho, wo = int(size[0]), int(size[1])
    return (dtype in UP_DTYPES and c % 8 == 0 and c > 0 and ho >= hi >= 1
            and wo >= wi >= 1 and (ho, wo) != (hi, wi))


def _halfpix_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) half-pixel bilinear matrix, float32 (upsample.py:46)."""
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float32)
    scale = n_in / n_out
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(pos).astype(np.int64)
    frac = (pos - lo).astype(np.float32)
    lo_c = np.clip(lo, 0, n_in - 1)
    hi_c = np.clip(lo + 1, 0, n_in - 1)
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, lo_c), 1.0 - frac)
    np.add.at(m, (rows, hi_c), frac)
    return m


@functools.cache
def _axis_tables(n_in: int, n_out: int):
    """numpy tables of one axis: forward (idx (n_out, 2) int32, weight
    (n_out, 2) f32), backward (idx (n_in, L) int32, weight (n_in, L) f32),
    all read from the `_halfpix_np` matrix."""
    m = _halfpix_np(n_in, n_out)
    fidx = np.zeros((n_out, 2), np.int32)
    fw = np.zeros((n_out, 2), np.float32)
    for o in range(n_out):
        nz = np.nonzero(m[o])[0]
        fidx[o, :] = nz[0]
        fw[o, 0] = m[o, nz[0]]
        if nz.size > 1:
            fidx[o, 1], fw[o, 1] = nz[1], m[o, nz[1]]
    lists = [np.nonzero(m[:, i])[0] for i in range(n_in)]
    width = max(len(ls) for ls in lists)
    bidx = np.full((n_in, width), -1, np.int32)
    bw = np.zeros((n_in, width), np.float32)
    for i, ls in enumerate(lists):
        bidx[i, :len(ls)] = ls
        bw[i, :len(ls)] = m[ls, i]
    return fidx, fw, bidx, bw


@functools.cache
def _tables(n_in, n_out, backward, dtype, device):
    """(idx int32, weight f32) of one axis on `device`, cached; the weights
    rounded to `dtype` first unless it is None."""
    fidx, fw, bidx, bw = _axis_tables(n_in, n_out)
    idx, w = (bidx, bw) if backward else (fidx, fw)
    w = torch.from_numpy(w)
    if dtype is not None:
        w = w.to(dtype).float()
    return torch.from_numpy(idx).to(device), w.to(device)


def resize_bilinear_up_ref(x, size):
    """Plain version: x (N, Hi, Wi, C) -> (N, Ho, Wo, C) in x's dtype."""
    ho, wo = int(size[0]), int(size[1])
    cdt = _pdt(x.dtype)
    ri, rw = _tables(x.shape[1], ho, False, None, x.device)
    ci, cw = _tables(x.shape[2], wo, False, x.dtype, x.device)
    ri, ci, rw, cw = ri.long(), ci.long(), rw.to(cdt), cw.to(cdt)
    xf = x.to(cdt)
    z = (rw[:, 0, None, None] * xf[:, ri[:, 0]]
         + rw[:, 1, None, None] * xf[:, ri[:, 1]])
    z = z.to(x.dtype).to(cdt)
    y = cw[:, 0, None] * z[:, :, ci[:, 0]] + cw[:, 1, None] * z[:, :, ci[:, 1]]
    return y.to(x.dtype)


def resize_bilinear_up_bwd_ref(g, in_hw):
    """Plain version of the gradient: g (N, Ho, Wo, C) -> (N, Hi, Wi, C) in
    g's dtype."""
    hi, wi = int(in_hw[0]), int(in_hw[1])
    cdt = _pdt(g.dtype)
    ri, rw = _tables(hi, g.shape[1], True, None, g.device)
    ci, cw = _tables(wi, g.shape[2], True, g.dtype, g.device)
    ri, ci = ri.long().clamp_min(0), ci.long().clamp_min(0)
    rw, cw = rw.to(cdt), cw.to(cdt)
    gf = g.to(cdt)
    u = torch.zeros((g.shape[0], g.shape[1], wi, g.shape[3]), dtype=cdt,
                    device=g.device)
    for q in range(ci.shape[1]):
        u = u + cw[:, q, None] * gf[:, :, ci[:, q]]
    gx = torch.zeros((g.shape[0], hi, wi, g.shape[3]), dtype=cdt,
                     device=g.device)
    for j in range(ri.shape[1]):
        gx = gx + rw[:, j, None, None] * u[:, ri[:, j]]
    return gx.to(g.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check_up(x, what):
    _check_act(x, what)
    if x.shape[-1] % 8:
        raise ValueError(f"{what} takes C divisible by 8, got {x.shape[-1]}")


def run_up_fwd(x, size):
    """up_fwd on x NHWC-contiguous -> (N, Ho, Wo, C)."""
    if x.device.type == "cpu":
        return resize_bilinear_up_ref(x, size)
    from .. import native

    _check_up(x, "up_fwd")
    n, hi, wi, c = x.shape
    ho, wo = int(size[0]), int(size[1])
    rows, rw = _tables(hi, ho, False, None, x.device)
    cols, cw = _tables(wi, wo, False, x.dtype, x.device)
    y = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
    err = native.library().kdcc_up_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), rows.data_ptr(), rw.data_ptr(),
        cols.data_ptr(), cw.data_ptr(), y.data_ptr(), n, hi, wi, ho, wo, c,
        _stream(x))
    native.check(err, f"up_fwd ({n},{hi},{wi},{c}) -> ({ho},{wo})")
    run_up_fwd.launches += 1
    return y


def run_up_bwd(g, in_hw):
    """up_bwd on g NHWC-contiguous -> (N, Hi, Wi, C), the input gradient."""
    if g.device.type == "cpu":
        return resize_bilinear_up_bwd_ref(g, in_hw)
    from .. import native

    _check_up(g, "up_bwd")
    n, ho, wo, c = g.shape
    hi, wi = int(in_hw[0]), int(in_hw[1])
    rl, rlw = _tables(hi, ho, True, None, g.device)
    cl, clw = _tables(wi, wo, True, g.dtype, g.device)
    gx = torch.empty((n, hi, wi, c), dtype=g.dtype, device=g.device)
    err = native.library().kdcc_up_bwd(
        _DTYPE_CODE[g.dtype], g.data_ptr(), rl.data_ptr(), rlw.data_ptr(),
        rl.shape[1], cl.data_ptr(), clw.data_ptr(), cl.shape[1], gx.data_ptr(),
        n, hi, wi, ho, wo, c, _stream(g))
    native.check(err, f"up_bwd ({n},{ho},{wo},{c}) -> ({hi},{wi})")
    run_up_bwd.launches += 1
    return gx


run_up_fwd.launches = run_up_bwd.launches = 0
KERNELS = (run_up_fwd, run_up_bwd)


class _Upsample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, size):
        ctx.in_hw = tuple(x.shape[1:3])
        return run_up_fwd(x, size)

    @staticmethod
    def backward(ctx, g):
        return run_up_bwd(g.contiguous(), ctx.in_hw), None


def resize_bilinear_up(x, size, layout: str = "NHWC"):
    """Half-pixel bilinear upsample of x (N, Hi, Wi, C), or with
    layout="NCHW" of x (N, C, Hi, Wi) (channels_last memory reads without a
    copy), to `size` = (Ho, Wo); the result in the same layout (NCHW: a view
    in channels_last memory). The guard is the caller's
    (`supports_upsample`)."""
    size = (int(size[0]), int(size[1]))
    if layout == "NCHW":
        y = _Upsample.apply(x.permute(0, 2, 3, 1).contiguous(), size)
        return y.permute(0, 3, 1, 2)
    if layout != "NHWC":
        raise ValueError(f"layout is NHWC or NCHW, got {layout}")
    return _Upsample.apply(x.contiguous(), size)


def resize_bilinear_up_sharded(x, size, group, layout: str = "NHWC"):
    """resize_bilinear_up on this rank's rows of a batch sharded over
    `group` (the JAX package's resize_bilinear_up_sharded,
    upsample.py:220). The upsample is per image, so each rank's local call
    is already exact: no collective, in either direction."""
    del group
    return resize_bilinear_up(x, size, layout)
