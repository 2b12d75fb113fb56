"""Depthwise conv, stride 1, 'same' padding, any dilation, with its backward
(kd_cheap_conv_tpu/ops/pallas/dwconv.py and dwhwnc.py: one computation in
two TPU layouts, one kernel family here).

On a CUDA tensor csrc/resample_dw.cu computes it: `dw_conv_kernel` the
forward (`run_dw_conv`) and, with the taps flipped, the input gradient
(`run_dw_dx`); `dkw::dw_dk_kernel` the weight gradient (`run_dw_dk`), one
launch on one wave that sums across its CTAs itself, over the work list
`dw_dk_plan` fixes from the shape (bands of rows in dilation-class order
`dw_dk_seq_rows`, blocks of channels, one contiguous run of items a CTA;
`dw_dk_items` lists it). On a CPU tensor the plain versions
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

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .stem import (_DTYPE_CODE, _check_act, _need, _pdt, _scratch, _stream,
                   _tickets)

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
    """(C, 1, k, k) weight -> (k * k, C) taps, f32 (f64 for f64): one copy
    that casts and transposes."""
    c, k = w.shape[0], w.shape[-1]
    return torch.empty((k * k, c), dtype=_pdt(w.dtype), device=w.device).copy_(
        w.reshape(c, k * k).t())


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


# csrc/resample_dw.cu dkw: consumer threads a CTA (a producer warp besides),
# CTAs of the wave (one an SM), bytes a shared-memory stage, sequence rows a
# band at most
DK_THREADS, DK_CTAS, DK_STAGE, DK_MAX_ROWS = 512, 132, 108 * 1024, 64


class DkPlan(NamedTuple):
    cpt: int       # channels a thread
    cb: int        # channels a block
    u: int         # threads across a block's channels
    pl: int        # pixel lanes
    hk: int        # halo, in sequence rows
    bands: int     # bands an image
    rows: int      # sequence rows a band
    nb: int        # items a block (images x bands)
    ncb: int       # blocks
    items: int
    grid: int      # CTAs
    mc: int        # scratch slots a block
    scratch: int   # f32 scratch floats: ncb x mc x k^2 x cb


@functools.lru_cache(maxsize=None)
def dw_dk_plan(n, h, w, c, k, esize):
    """The weight-gradient kernel's work list for a shape, from the shape
    alone (mirrors dkw::plan; the kernel refuses another grid or scratch
    size): rows staged as ceil(w / 256) TMA boxes of equal width (a
    multiple of 8 pixels when there are several), each row 128-byte
    aligned; blocks of cb channels, the widest of 128, 64, 32 or
    16 bytes a pixel dividing C (whole 128-byte lines where C allows) whose
    flush ([warp][k^2][cb] f32) and a one-row band fit a DK_STAGE stage;
    bands of `rows` sequence rows: of the band counts whose x rows (a halo
    of k // 2 either side) and g rows fit a stage, the one with the least
    ceil(items / grid) x (x rows + g rows + 2); items (block, image, band)
    block-major, one contiguous run of items for each of `grid` CTAs."""
    cpt, hk = (4 if k == 3 else 2), k // 2
    nbox = -(-w // 256)
    bw = w if nbox == 1 else (-(-w // nbox) + 7) // 8 * 8   # 128-byte aligned boxes
    best = None
    for nbytes in (128, 64, 32, 16):
        cb = nbytes // esize
        if c % cb or DK_THREADS // 32 * k * k * cb * 4 > DK_STAGE:
            continue
        row = -(-nbox * bw * nbytes // 128) * 128
        for b in range(1, h + 1):
            rows = -(-h // b)
            xr = min(h, rows + 2 * hk)
            if rows > DK_MAX_ROWS or (xr + rows) * row > DK_STAGE:
                continue
            items = n * b * (c // cb)
            cost = -(-items // min(items, DK_CTAS)) * (xr + rows + 2)
            if best is None or cost < best[0]:
                best = (cost, b, cb)
        if best is not None:
            break
    if best is None:
        raise ValueError(f"dw_dk: a row of {w} pixels does not fit a "
                         f"{DK_STAGE}-byte stage")
    _, bands, cb = best
    rows = -(-h // bands)
    nb, ncb = n * bands, c // cb
    items = nb * ncb
    grid = min(items, DK_CTAS)
    mc = min(nb, -(-grid // ncb) + 1)
    return DkPlan(cpt, cb, cb // cpt, DK_THREADS // (cb // cpt), hk, bands,
                  rows, nb, ncb, items, grid, mc, ncb * mc * k * k * cb)


def dw_dk_seq_rows(h, d):
    """The image rows in dilation-class order (dkw::seq_row): row r + j d
    of class r = y mod d, the classes in order, so a tap row of any
    dilation reaches k // 2 sequence rows either side."""
    return [y for r in range(min(d, h)) for y in range(r, h, d)]


def dw_dk_items(n, h, w, c, k, d, esize):
    """The kernel's items in CTA order: [(CTA, block, image, g image rows,
    staged x image rows)] (dkw::item_at and the runs [j I / G, (j + 1) I /
    G))."""
    p = dw_dk_plan(n, h, w, c, k, esize)
    seq = dw_dk_seq_rows(h, d)
    out = []
    for j in range(p.grid):
        for i in range(j * p.items // p.grid, (j + 1) * p.items // p.grid):
            blk, rest = divmod(i, p.nb)
            img, band = divmod(rest, p.bands)
            s0 = band * p.rows
            s1 = min(h, s0 + p.rows)
            out.append((j, blk, img, seq[s0:s1],
                        seq[max(0, s0 - p.hk):min(h, s1 + p.hk)]))
    return out


DW_DK = "dw_dk"


def run_dw_dk(x, g, k, dilation):
    """Weight gradient (k * k, C) f32 from x and g (N, H, W, C): one
    kernel launch, summed across its CTAs in the kernel."""
    if x.device.type == "cpu":
        return depthwise_dk_ref(x, g, k, dilation)
    from .. import native

    n, h, w, c = x.shape
    _check_dw(x, None, k, dilation, "dw_dk")
    _need(g, "g", x.shape, x.dtype, x.device)
    if x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("dw_dk copies 16 bytes at a time: x and g must be "
                         "16-byte aligned")
    pl = dw_dk_plan(n, h, w, c, k, x.element_size())
    dev = x.device
    dk = torch.empty((k * k, c), dtype=torch.float32, device=dev)
    err = native.library().kdcc_dw_dk(
        _DTYPE_CODE[x.dtype], x.data_ptr(), g.data_ptr(), dk.data_ptr(),
        _scratch(dev, DW_DK, pl.scratch).data_ptr(),
        _tickets(dev, DW_DK, pl.ncb).data_ptr(), n, h, w, c, k, dilation,
        pl.grid, pl.scratch, _stream(x))
    native.check(err, f"dw_dk ({n},{h},{w},{c}) k{k} d{dilation}")
    run_dw_dk.launches += 1
    return dk


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
