"""CE + softened KL over class-major logits, fused: over bilinearly
upsampled head-resolution logits (the live KD step) and over full-resolution
ones (the cached-teacher step), the JAX package's ops/pallas/losses.py.
The full-resolution half, `fused_ce_kl_loss` with its kernels `ce_kl_fwd` /
`ce_kl_bwd` (csrc/ce_kl.cu) and plain versions `ce_kl_fwd_ref` /
`ce_kl_bwd_ref`, is at the end of this module; the rest is the upsampled
half.

`fused_ce_kl_loss_upsampled(s_small, t_small, labels, out_h, out_w, ...)`
takes head-resolution (N, C, h, w) student and teacher logits and
full-resolution (N, out_h, out_w) labels, and returns (total, task, kd)
exactly as upsampling both to (out_h, out_w) (half-pixel bilinear, source
index clamped to [0, in - 1]) and then taking

    task = sum over valid pixels of (lse(s) - s[label]) / max(#valid, 1)
    kd   = T^2 * sum over all pixels of KL(softmax(t/T) || softmax(s/T)) / (N H W)
    total = alpha * task + beta * kd

would, without the full-resolution logits ever reaching device memory.
Valid means label != ignore_index; a label outside [0, C) is not masked (its
one-hot is all zero), as in the JAX kernel. The teacher is clipped to
+-teacher_logit_clip at head resolution, before the upsample (the JAX
kernel's order), and log p_t is clamped at -87 before its exp. All math is
float32; the logits may be float32 or bfloat16. The plain versions compute
in float64 for float64 logits: on a CUDA tensor F.interpolate takes its
source coordinates in the input's precision, in float32 up to an ulp of
the coordinate off (~1.5e-5 at 193 -> 769, where the kernels' tables come
from float64), so at config #3's size only a float64 plain version is a
yardstick for the kernels. `fused_ce_loss_upsampled`
is the beta = 0 instance (supervised CE), which never reads a teacher.

Two kernels carry it, both in csrc/ce_kl_upsampled.cu:

- kernel C (`ce_kl_upsampled_fwd`): the three sums (nll * valid, valid,
  kl), each output pixel computed once by the head-resolution tile that
  holds its lower taps, summed in the kernel in a fixed order;
- kernel D (`ce_kl_upsampled_bwd`): ds at head resolution from the two
  grad scales that the autograd backward folds from the three cotangents
  (the JAX package's `_grad_scales`). It gathers: each head-resolution
  pixel sums the full-resolution pixels that tap it, in a fixed order, so
  the result does not depend on scheduling.

Each wrapper takes its plain PyTorch version (`*_ref`: F.interpolate, then
the full-resolution plain versions, and for the backward the
interpolation's own VJP) for a tensor on the CPU, and on a CUDA tensor launches its kernel or raises.
Each counts its launches in its `launches` attribute.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .losses import NEG_CLAMP
from .stem import _pdt, _scratch, _stream, _tickets

# kernel D: an 8 x 16 head-resolution tile per CTA of 256 threads, its
# passes sized at about BWD_PASS_PIXELS full-resolution pixels; kernel C:
# the same tiles (the last of an axis taking one more row or column where
# one is left) walked by one wave of at most FWD_SLOTS CTAs of FWD_THREADS
# (four an SM), FWD_RED floats of the warps' sums and a flag beside the
# windows and tap tables
BWD_TY, BWD_TX, BWD_THREADS = 8, 16, 256
BWD_PASS_PIXELS = 3 * BWD_THREADS
FWD_THREADS, FWD_SLOTS = 128, 4 * 132
FWD_RED = 4 * FWD_THREADS // 32 + 4
# the kernels keep one pixel's upsampled logits in registers
MAX_CLASSES = 32
SMEM_LIMIT = 232_448
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# the bilinear map (shape-only), shared by the kernels and the plain versions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def axis_tables(in_size: int, out_size: int):
    """Half-pixel bilinear taps along one axis, as the JAX package's
    `bilinear_matrix` builds them: output o reads lo[o] with weight
    1 - frac[o] and min(lo[o] + 1, in - 1) with weight frac[o]. Also, for
    each input index i, the output range [ob[i], oe[i]) whose taps touch it
    (empty where no output does). Numpy arrays: lo, ob, oe int32; frac f32."""
    pos = (np.arange(out_size, dtype=np.float64) + 0.5) * in_size / out_size
    pos = np.clip(pos - 0.5, 0.0, in_size - 1)
    lo = np.floor(pos).astype(np.int64)
    frac = (pos - lo).astype(np.float32)
    hi = np.minimum(lo + 1, in_size - 1)
    idx = np.arange(in_size)
    # lo and hi are nondecreasing, so {o : lo[o] <= i <= hi[o]} is a range
    ob = np.searchsorted(hi, idx, side="left")
    oe = np.searchsorted(lo, idx, side="right")
    oe = np.maximum(oe, ob)
    return (lo.astype(np.int32), frac, ob.astype(np.int32),
            oe.astype(np.int32))


def _window(lo, in_size, first, last):
    """Input rows [lo[first], hi[last]] that outputs first..last read."""
    return int(lo[first]), int(min(lo[last] + 1, in_size - 1))


def fwd_tiles(in_size: int, tile: int) -> int:
    """Kernel C's tiles along an axis of in_size head pixels: tiles of
    `tile`, the last taking the rest (up to tile + 1; cfw::axis_tiles)."""
    return max(1, (in_size + tile - 2) // tile)


@functools.lru_cache(maxsize=None)
def fwd_bounds(in_size: int, out_size: int, tile: int):
    """Kernel C's tiles along an axis: tile i owns the outputs [b[i],
    b[i + 1]), those whose lower tap lo lies in it (lo is nondecreasing,
    so every output falls in exactly one tile). Numpy int32, one more
    entry than tiles."""
    lo = axis_tables(in_size, out_size)[0]
    starts = np.arange(fwd_tiles(in_size, tile)) * tile
    return np.append(np.searchsorted(lo, starts, side="left"),
                     out_size).astype(np.int32)


@functools.lru_cache(maxsize=None)
def fwd_grid(n: int, h: int, w: int):
    """Kernel C's split (cfw::plan): (tiles, tiles a CTA walks, CTAs); CTA
    b walks tiles [b per, (b + 1) per), per as few as one wave of FWD_SLOTS
    CTAs allows."""
    tiles = n * fwd_tiles(h, BWD_TY) * fwd_tiles(w, BWD_TX)
    per = -(-tiles // FWD_SLOTS)
    return tiles, per, -(-tiles // per)


@functools.lru_cache(maxsize=None)
def plan(h: int, w: int, out_h: int, out_w: int) -> dict:
    """Launch geometry of kernels C and D for one (h, w) -> (out_h, out_w):
    kernel C's most output rows and columns a tile owns (fwd_reg); kernel
    D's largest head-resolution window, its largest full-resolution region
    of a tile (reg_h x reg_w pixels tap it) and the rows of one pass: the
    region's rows split into as few passes of about BWD_PASS_PIXELS pixels
    as there are, evenly."""
    ty, tx = axis_tables(h, out_h), axis_tables(w, out_w)

    def bwd_win(tab, in_size, tile):
        lo, _, ob, oe = tab
        spans, regions = [1], [1]
        for i0 in range(0, in_size, tile):
            i1 = min(i0 + tile, in_size)
            rb, re = int(ob[i0]), int(oe[i1 - 1])
            if rb < re:
                a, b = _window(lo, in_size, rb, re - 1)
                spans.append(b - a + 1)
                regions.append(re - rb)
        return max(spans), max(regions)

    bwd_wy, reg_h = bwd_win(ty, h, BWD_TY)
    bwd_wx, reg_w = bwd_win(tx, w, BWD_TX)
    passes = -(-reg_h * reg_w // BWD_PASS_PIXELS)
    fwd_reg = tuple(int(np.diff(fwd_bounds(size, out, tile)).max())
                    for size, out, tile in ((h, out_h, BWD_TY),
                                            (w, out_w, BWD_TX)))
    return {"fwd_reg": fwd_reg, "bwd_win": (bwd_wy, bwd_wx), "reg_h": reg_h,
            "reg_w": reg_w, "rows": -(-reg_h // passes)}


def fwd_smem_bytes(c, p, with_kl):
    """Kernel C's dynamic shared memory (cfw::smem_bytes, which refuses
    another total): the windows (as kernel D's), the tap tables (lo and
    frac of fwd_reg's rows and columns), the warps' sums and a flag."""
    rh, rw = p["fwd_reg"]
    win = (BWD_TY + 2) * (BWD_TX + 2)
    return 4 * ((2 if with_kl else 1) * c * win + 2 * rh + 2 * rw + FWD_RED)


def bwd_smem_bytes(c, p, with_kl):
    """Kernel D's dynamic shared memory (csrc/ce_kl_upsampled.cu
    dbw::smem_bytes, which refuses another total): the windows (each
    (BWD_TY + 2) x (BWD_TX + 2), which holds any tile's: its pixels tap
    within one head pixel of it), a pass's g and horizontal sums, the
    tile's accumulators, the tap tables."""
    rows, reg_h, reg_w = p["rows"], p["reg_h"], p["reg_w"]
    win = (BWD_TY + 2) * (BWD_TX + 2)
    return 4 * (c * ((2 if with_kl else 1) * win + rows * bwd_gs_ld(reg_w)
                     + rows * BWD_TX + BWD_TY * BWD_TX)
                + 2 * reg_w + 2 * reg_h + 2 * BWD_TX + 2 * BWD_TY)


def bwd_gs_ld(reg_w):
    """Kernel D's row stride of g (dbw::gs_ld): reg_w columns skewed by one
    every 32, rounded up to 2 mod 4."""
    w = reg_w + (reg_w - 1) // 32 + 1
    return w + (6 - w % 4) % 4


@functools.lru_cache(maxsize=None)
def _device_tables(h, w, out_h, out_w, device):
    """lo, frac, ob, oe of rows, then of columns (both kernels), then
    kernel C's tile bounds of rows and of columns."""
    ty, tx = axis_tables(h, out_h), axis_tables(w, out_w)
    return tuple(torch.from_numpy(a).to(device) for a in (
        *ty, *tx, fwd_bounds(h, out_h, BWD_TY), fwd_bounds(w, out_w, BWD_TX)))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _upsampled(x_small, out_h, out_w, clip=0.0):
    x = x_small.to(_pdt(x_small.dtype))
    if clip:
        x = x.clamp(-clip, clip)
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False)


def _lse(x):
    """max + log(sum(exp(x - max))) over the classes, in the JAX kernel's
    order: log p = x - lse rounds at lse's magnitude, as the kernels do
    (F.log_softmax subtracts the max first; at a teacher on the 3e4 clip,
    x / T ~ 7500, the two differ by up to an ulp of 7500 per class)."""
    m = x.amax(1)
    return m + torch.log(torch.exp(x - m.unsqueeze(1)).sum(1))


def _teacher(t, teacher_logit_clip):
    t = t.to(_pdt(t.dtype))
    return (t.clamp(-teacher_logit_clip, teacher_logit_clip)
            if teacher_logit_clip else t)


def ce_kl_fwd_ref(s, t, labels, temperature, ignore_index,
                  teacher_logit_clip):
    """Plain version of the full-resolution forward kernel: (sum nll *
    valid, sum valid, sum kl) in f32, as the JAX `_fwd_kernel` computes
    them; t None -> CE only (kl = 0)."""
    c = s.shape[1]
    labels = labels.long()
    s = s.to(_pdt(s.dtype))
    in_range = (labels >= 0) & (labels < c)
    safe = torch.where(in_range, labels, torch.zeros_like(labels))
    s_lbl = s.gather(1, safe.unsqueeze(1)).squeeze(1) * in_range
    nll = _lse(s) - s_lbl
    valid = (labels != ignore_index).to(s.dtype)
    kl = torch.zeros((), dtype=s.dtype, device=s.device)
    if t is not None:
        s_t = s / temperature
        t_t = _teacher(t, teacher_logit_clip) / temperature
        log_p_s = s_t - _lse(s_t).unsqueeze(1)
        log_p_t = (t_t - _lse(t_t).unsqueeze(1)).clamp_min(NEG_CLAMP)
        kl = (log_p_t.exp() * (log_p_t - log_p_s)).sum()
    return torch.stack([(nll * valid).sum(), valid.sum(), kl])


def ce_kl_bwd_ref(s, t, labels, scales, temperature, ignore_index,
                  teacher_logit_clip):
    """Plain version of the full-resolution backward kernel: the per-pixel
    a * (softmax(s) - onehot) * valid + k * (softmax(s/T) - softmax(t/T)),
    `scales` = (a, k); t None -> the CE term only. ds in s's dtype."""
    c = s.shape[1]
    labels = labels.long()
    sf = s.to(_pdt(s.dtype))
    cls = torch.arange(c, device=s.device).view(1, c, 1, 1)
    onehot = (cls == labels.unsqueeze(1)).to(sf.dtype)
    valid = (labels != ignore_index).to(sf.dtype).unsqueeze(1)
    g = scales[0] * (torch.softmax(sf, 1) - onehot) * valid
    if t is not None:
        t = _teacher(t, teacher_logit_clip)
        g = g + scales[1] * (torch.softmax(sf / temperature, 1)
                             - torch.softmax(t / temperature, 1))
    return g.to(s.dtype)


def ce_kl_upsampled_fwd_ref(s_small, t_small, labels, out_h, out_w,
                            temperature, ignore_index, teacher_logit_clip):
    """Plain version of kernel C: the full-resolution sums of the logits
    upsampled by F.interpolate (the teacher clipped first)."""
    t = (None if t_small is None
         else _upsampled(t_small, out_h, out_w, teacher_logit_clip))
    return ce_kl_fwd_ref(_upsampled(s_small, out_h, out_w), t, labels,
                         temperature, ignore_index, 0.0)


def ce_kl_upsampled_bwd_ref(s_small, t_small, labels, scales, out_h, out_w,
                            temperature, ignore_index, teacher_logit_clip):
    """Plain version of kernel D: the full-resolution per-pixel gradient of
    the upsampled logits, taken back through the interpolation's VJP;
    `scales` is the (a, k) pair. Returns ds in the dtype of s_small."""
    t = (None if t_small is None
         else _upsampled(t_small, out_h, out_w, teacher_logit_clip))
    with torch.enable_grad():
        s_in = s_small.detach().to(_pdt(s_small.dtype)).requires_grad_()
        s_up = F.interpolate(s_in, size=(out_h, out_w), mode="bilinear",
                             align_corners=False)
        g = ce_kl_bwd_ref(s_up.detach(), t, labels, scales, temperature,
                          ignore_index, 0.0)
        (ds,) = torch.autograd.grad(s_up, s_in, g)
    return ds.to(s_small.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check(s_small, t_small, labels, out_h, out_w):
    if s_small.device.type != "cuda":
        raise ValueError(f"the fused loss runs on CUDA or CPU tensors, got "
                         f"{s_small.device}")
    if s_small.dtype not in _DTYPE_CODE:
        raise TypeError(f"the fused loss takes float32 or bfloat16 logits, "
                        f"got {s_small.dtype}")
    if s_small.dim() != 4 or not s_small.is_contiguous():
        raise ValueError("the fused loss takes contiguous (N, C, h, w) "
                         "class-major logits")
    n, c = s_small.shape[:2]
    if c > MAX_CLASSES:
        raise ValueError(f"the fused loss kernels take at most {MAX_CLASSES} "
                         f"classes, got {c}")
    if t_small is not None and (
            t_small.shape != s_small.shape or t_small.dtype != s_small.dtype
            or t_small.device != s_small.device
            or not t_small.is_contiguous()):
        raise ValueError("teacher logits must match the student's shape, "
                         "dtype, device and be contiguous")
    if labels.dtype != torch.int64:
        raise TypeError(f"labels must be int64, got {labels.dtype}")
    if (tuple(labels.shape) != (n, out_h, out_w)
            or labels.device != s_small.device or not labels.is_contiguous()):
        raise ValueError(f"labels must be contiguous ({n}, {out_h}, {out_w}) "
                         f"on {s_small.device}, got {tuple(labels.shape)} on "
                         f"{labels.device}")


def _common(s_small, t_small, out_h, out_w):
    n, c, h, w = s_small.shape
    dev = s_small.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return (n, c, h, w, plan(h, w, out_h, out_w),
            _device_tables(h, w, out_h, out_w, dev),
            torch.cuda.current_stream(idx).cuda_stream,
            t_small if t_small is not None else s_small)


CE_KL_UP_FWD = "ce_kl_up_fwd"


def ce_kl_upsampled_fwd(s_small, t_small, labels, out_h: int, out_w: int,
                        temperature: float, ignore_index: int = 255,
                        teacher_logit_clip: float = 0.0):
    """Kernel C. Returns the float32 sums (nll * valid, valid, kl) as a
    (3,) tensor on the logits' device, summed in the kernel; t_small None
    -> CE only (kl = 0)."""
    if s_small.device.type == "cpu":
        return ce_kl_upsampled_fwd_ref(s_small, t_small, labels, out_h, out_w,
                                       temperature, ignore_index,
                                       teacher_logit_clip)
    from .. import native

    _check(s_small, t_small, labels, out_h, out_w)
    n, c, h, w, p, tabs, stream, t_arg = _common(s_small, t_small, out_h,
                                                 out_w)
    with_kl = t_small is not None
    smem = fwd_smem_bytes(c, p, with_kl)
    if smem > SMEM_LIMIT:
        raise ValueError(f"kernel C: {c} classes over tiles of "
                         f"{p['fwd_reg']} outputs need {smem} bytes of "
                         f"shared memory")
    grid = fwd_grid(n, h, w)[2]
    dev = s_small.device
    out = torch.empty((3,), dtype=torch.float32, device=dev)
    lo_y, fy, _, _, lo_x, fx, _, _, tb_y, tb_x = tabs
    err = native.library().kdcc_ce_kl_up_fwd(
        _DTYPE_CODE[s_small.dtype], s_small.data_ptr(), t_arg.data_ptr(),
        labels.data_ptr(), lo_y.data_ptr(), fy.data_ptr(), lo_x.data_ptr(),
        fx.data_ptr(), tb_y.data_ptr(), tb_x.data_ptr(), out.data_ptr(),
        _scratch(dev, CE_KL_UP_FWD, 4 * grid).data_ptr(),
        _tickets(dev, CE_KL_UP_FWD, 1).data_ptr(), n, c, h, w, out_h, out_w,
        1.0 / float(temperature), float(teacher_logit_clip), ignore_index,
        int(with_kl), *p["fwd_reg"], grid, smem, stream)
    native.check(err, f"ce_kl_up_fwd ({n},{c},{h},{w}) -> {out_h}x{out_w}")
    ce_kl_upsampled_fwd.launches += 1
    return out


def ce_kl_upsampled_bwd(s_small, t_small, labels, scales, out_h: int,
                        out_w: int, temperature: float,
                        ignore_index: int = 255,
                        teacher_logit_clip: float = 0.0):
    """Kernel D. `scales` holds the grad scales (a, k) as a float32 tensor
    on the logits' device; returns ds with the shape and dtype of s_small.
    t_small None -> the CE term only."""
    if s_small.device.type == "cpu":
        return ce_kl_upsampled_bwd_ref(s_small, t_small, labels, scales,
                                       out_h, out_w, temperature,
                                       ignore_index, teacher_logit_clip)
    from .. import native

    _check(s_small, t_small, labels, out_h, out_w)
    scales = scales.to(device=s_small.device,
                       dtype=torch.float32).contiguous()
    if scales.shape != (2,):
        raise ValueError(f"scales must be (a, k), got {tuple(scales.shape)}")
    n, c, h, w, p, tabs, stream, t_arg = _common(s_small, t_small, out_h,
                                                 out_w)
    with_kl = t_small is not None
    smem = bwd_smem_bytes(c, p, with_kl)
    if smem > SMEM_LIMIT:
        raise ValueError(f"kernel D: {c} classes over a {p['bwd_win']} "
                         f"window need {smem} bytes of shared memory")
    ds = torch.empty_like(s_small)
    err = native.library().kdcc_ce_kl_up_bwd(
        _DTYPE_CODE[s_small.dtype], s_small.data_ptr(), t_arg.data_ptr(),
        labels.data_ptr(), *(t.data_ptr() for t in tabs[:8]),
        scales.data_ptr(),
        ds.data_ptr(), n, c, h, w, out_h, out_w, 1.0 / float(temperature),
        float(teacher_logit_clip), ignore_index, int(with_kl),
        p["bwd_win"][0], p["bwd_win"][1], p["reg_h"], p["reg_w"], p["rows"],
        smem, stream)
    native.check(err, f"ce_kl_up_bwd ({n},{c},{h},{w}) -> {out_h}x{out_w}")
    ce_kl_upsampled_bwd.launches += 1
    return ds


ce_kl_upsampled_fwd.launches = 0
ce_kl_upsampled_bwd.launches = 0


# ---------------------------------------------------------------------------
# the loss with its gradient
# ---------------------------------------------------------------------------

class _CEKLUpsampled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s_small, t_small, labels, out_h, out_w, temperature,
                alpha, beta, ignore_index, teacher_logit_clip):
        t_used = t_small if beta != 0.0 else None
        sums = ce_kl_upsampled_fwd(s_small, t_used, labels, out_h, out_w,
                                   temperature, ignore_index,
                                   teacher_logit_clip)
        npix = float(s_small.shape[0] * out_h * out_w)
        denom = sums[1].clamp_min(1.0)
        task = sums[0] / denom
        kd = (temperature ** 2) * sums[2] / npix
        total = alpha * task + beta * kd
        ctx.save_for_backward(s_small, t_used, labels, denom)
        ctx.args = (out_h, out_w, temperature, alpha, beta, ignore_index,
                    teacher_logit_clip, npix)
        return total, task, kd

    @staticmethod
    def backward(ctx, g_total, g_task, g_kd):
        s_small, t_used, labels, denom = ctx.saved_tensors
        out_h, out_w, temperature, alpha, beta, ignore_index, clip, npix = \
            ctx.args
        # the JAX package's _grad_scales: fold the three cotangents
        a_scale = (g_total * alpha + g_task) / denom
        k_scale = (g_total * beta + g_kd) * temperature / npix
        scales = torch.stack([a_scale, k_scale]).float()
        ds = ce_kl_upsampled_bwd(s_small, t_used, labels, scales, out_h,
                                 out_w, temperature, ignore_index, clip)
        return ds, None, None, None, None, None, None, None, None, None


def fused_ce_kl_loss_upsampled(s_small, t_small, labels, out_h: int,
                               out_w: int, temperature: float = 4.0,
                               alpha: float = 0.5, beta: float = 0.5,
                               ignore_index: int = 255,
                               teacher_logit_clip: float = 3e4):
    """(total, task, kd) of CE + T^2 KL over logits upsampled to
    (out_h, out_w); see the module docstring. The teacher gets no gradient;
    with beta = 0 it is not read."""
    return _CEKLUpsampled.apply(s_small.contiguous(), t_small.contiguous(),
                                labels, int(out_h), int(out_w),
                                float(temperature), float(alpha), float(beta),
                                int(ignore_index), float(teacher_logit_clip))


def fused_ce_loss_upsampled(s_small, labels, out_h: int, out_w: int,
                            ignore_index: int = 255):
    """Supervised CE over logits upsampled to (out_h, out_w): the beta = 0
    instance, which reads no teacher. Returns the mean CE."""
    _, task, _ = fused_ce_kl_loss_upsampled(s_small, s_small, labels, out_h,
                                            out_w, 1.0, 1.0, 0.0,
                                            ignore_index, 0.0)
    return task


# ---------------------------------------------------------------------------
# the full-resolution loss (the cached-teacher step): the JAX package's
# fused_ce_kl_loss, csrc/ce_kl.cu
# ---------------------------------------------------------------------------

# the teacher's dtypes the full-resolution kernels read (the cache stores
# float16)
_T_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# csrc/ce_kl.cu's launch: tiles of at most FULL_TILE pixels, at most
# FULL_CTAS CTAs (one an SM), each with at most FULL_SMEM bytes of dynamic
# shared memory, a ring of FULL_MIN_RING to FULL_RING slots and FULL_FIXED
# bytes beside it
FULL_TILE, FULL_CTAS, FULL_SMEM, FULL_FIXED = 1024, 132, 227 * 1024, 512
FULL_RING, FULL_MIN_RING = 4, 2


@functools.lru_cache(maxsize=None)
def full_plan(n: int, c: int, hw: int, s_bytes: int, t_bytes: int,
              nhwc: bool) -> dict:
    """The full-resolution kernels' plan (mirrors csrc/ce_kl.cu's plan; the
    kernels refuse another grid or shared memory size) for n images of hw
    pixels and c classes, s and t of s_bytes and t_bytes an element, the
    teacher NHWC or class-major: tiles of `tile` pixels (FULL_TILE, or the
    largest of a half, quarter or eighth of it of which two slots fit)
    inside one image; a ring slot holds a tile's c spans of s, its teacher
    (one NHWC span or c plane spans) and its labels, each span 16 bytes
    more than its bytes (room for its 16-byte-aligned superset, the unit
    the copies move); as many slots as FULL_SMEM holds, at most FULL_RING;
    CTA b walks tiles [b per, (b + 1) per)."""
    for tile in (FULL_TILE, FULL_TILE // 2, FULL_TILE // 4, FULL_TILE // 8):
        s_ld = tile * s_bytes + 16
        t_ld = tile * (c if nhwc else 1) * t_bytes + 16
        slot = c * s_ld + (1 if nhwc else c) * t_ld + tile * 8 + 16
        ring = min(FULL_RING, (FULL_SMEM - FULL_FIXED) // slot)
        if ring >= FULL_MIN_RING:
            break
    tiles = n * -(-hw // tile)
    per = -(-tiles // FULL_CTAS)
    return {"tile": tile, "ring": ring, "slot": slot, "per": per,
            "grid": -(-tiles // per), "smem": FULL_FIXED + ring * slot}


def _teacher_strides(s, t):
    """(class stride, pixel stride) of t within one image, for a t of s's
    shape laid out class-major (NCHW contiguous) or pixel-major (the NHWC
    memory of an NCHW channels_last view, as the cache delivers it)."""
    n, c, h, w = s.shape
    if tuple(t.shape) != (n, c, h, w):
        raise ValueError(f"teacher logits {tuple(t.shape)} do not match the "
                         f"student's {(n, c, h, w)}")
    st = t.stride()
    if st == (c * h * w, h * w, w, 1):
        return h * w, 1
    if st == (c * h * w, 1, w * c, c):
        return 1, c
    raise ValueError(f"teacher logits must be class-major or the NCHW view "
                     f"of NHWC memory, got strides {st}")


def _check_full(s, t, labels):
    _check(s, None, labels, *s.shape[-2:])
    if t.dtype not in _T_DTYPE_CODE or t.device != s.device:
        raise TypeError(f"the full-resolution loss takes float32, bfloat16 "
                        f"or float16 teacher logits on {s.device}, got "
                        f"{t.dtype} on {t.device}")
    if s.numel() >= 2 ** 31:
        raise ValueError(f"{s.numel()} logits exceed the kernels' 32-bit "
                         f"pixel index")
    return _teacher_strides(s, t)


def _launch_full(s, t, labels):
    """(dtype codes and NHWC flag, n, c, hw, plan) of a full-resolution
    launch, after the guards."""
    _, t_ps = _check_full(s, t, labels)
    n, c, h, w = s.shape
    nhwc = t_ps != 1
    return ((_DTYPE_CODE[s.dtype], _T_DTYPE_CODE[t.dtype], int(nhwc)), n, c,
            h * w, full_plan(n, c, h * w, s.element_size(), t.element_size(),
                             nhwc))


CE_KL_FWD = "ce_kl_fwd"


def ce_kl_fwd(s, t, labels, temperature: float, ignore_index: int = 255,
              teacher_logit_clip: float = 0.0):
    """The forward kernel: the float32 sums (nll * valid, valid, kl) as a
    (3,) tensor on the logits' device, summed in the kernel."""
    if s.device.type == "cpu":
        return ce_kl_fwd_ref(s, t, labels, temperature, ignore_index,
                             teacher_logit_clip)
    from .. import native

    codes, n, c, hw, p = _launch_full(s, t, labels)
    dev = s.device
    out = torch.empty((3,), dtype=torch.float32, device=dev)
    err = native.library().kdcc_ce_kl_fwd(
        *codes, s.data_ptr(), t.data_ptr(), labels.data_ptr(), out.data_ptr(),
        _scratch(dev, CE_KL_FWD, 4 * p["grid"]).data_ptr(),
        _tickets(dev, CE_KL_FWD, 1).data_ptr(), n, c, hw,
        1.0 / float(temperature), float(teacher_logit_clip), ignore_index,
        p["grid"], p["smem"], _stream(s))
    native.check(err, f"ce_kl_fwd ({n},{c},{hw})")
    ce_kl_fwd.launches += 1
    return out


def ce_kl_bwd(s, t, labels, scales, temperature: float,
              ignore_index: int = 255, teacher_logit_clip: float = 0.0):
    """The backward kernel: ds with the shape and dtype of s from the grad
    scales (a, k), a float32 tensor on the logits' device."""
    if s.device.type == "cpu":
        return ce_kl_bwd_ref(s, t, labels, scales, temperature, ignore_index,
                             teacher_logit_clip)
    from .. import native

    codes, n, c, hw, p = _launch_full(s, t, labels)
    scales = scales.to(device=s.device, dtype=torch.float32).contiguous()
    if scales.shape != (2,):
        raise ValueError(f"scales must be (a, k), got {tuple(scales.shape)}")
    ds = torch.empty_like(s)
    err = native.library().kdcc_ce_kl_bwd(
        *codes, s.data_ptr(), t.data_ptr(), labels.data_ptr(),
        scales.data_ptr(), ds.data_ptr(), n, c, hw, 1.0 / float(temperature),
        float(teacher_logit_clip), ignore_index, p["grid"], p["smem"],
        _stream(s))
    native.check(err, f"ce_kl_bwd ({n},{c},{hw})")
    ce_kl_bwd.launches += 1
    return ds


ce_kl_fwd.launches = 0
ce_kl_bwd.launches = 0


class _CEKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, t, labels, temperature, alpha, beta, ignore_index,
                teacher_logit_clip):
        sums = ce_kl_fwd(s, t, labels, temperature, ignore_index,
                         teacher_logit_clip)
        npix = float(s.shape[0] * s.shape[2] * s.shape[3])
        denom = sums[1].clamp_min(1.0)
        task = sums[0] / denom
        kd = (temperature ** 2) * sums[2] / npix
        total = alpha * task + beta * kd
        ctx.save_for_backward(s, t, labels, denom)
        ctx.args = (temperature, alpha, beta, ignore_index,
                    teacher_logit_clip, npix)
        return total, task, kd

    @staticmethod
    def backward(ctx, g_total, g_task, g_kd):
        s, t, labels, denom = ctx.saved_tensors
        temperature, alpha, beta, ignore_index, clip, npix = ctx.args
        # the JAX package's _grad_scales: fold the three cotangents
        a_scale = (g_total * alpha + g_task) / denom
        k_scale = (g_total * beta + g_kd) * temperature / npix
        ds = ce_kl_bwd(s, t, labels, torch.stack([a_scale, k_scale]).float(),
                       temperature, ignore_index, clip)
        return ds, None, None, None, None, None, None, None


def fused_ce_kl_loss(s, t, labels, temperature: float = 4.0,
                     alpha: float = 0.5, beta: float = 0.5,
                     ignore_index: int = 255,
                     teacher_logit_clip: float = 3e4):
    """(total, task, kd) of alpha * CE + beta * T^2 * mean_pix KL(p_t || p_s)
    on full-resolution (N, C, H, W) logits: s class-major (made contiguous
    here), t class-major or the NCHW view of NHWC memory in f32, bf16 or
    f16 (read as stored), labels (N, H, W) int64. The teacher is clipped to
    +-teacher_logit_clip and gets no gradient."""
    return _CEKL.apply(s.contiguous(), t.detach(), labels, float(temperature),
                       float(alpha), float(beta), int(ignore_index),
                       float(teacher_logit_clip))
