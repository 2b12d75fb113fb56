"""Fused train-mode DeepLabV3+ decoder head (kd_cheap_conv_tpu/ops/pallas/
decoder.py `fused_decoder_head_folded`).

The cheap-conv head's fuse and classifier: cat(low, up) -> depthwise 3x3
(pad 1) -> pointwise Ci -> Cm -> train-mode BN -> relu -> 1x1 Cm -> nc +
bias, as two forward and two backward passes around the BN's batch
barrier. The concat is never built: the kernels read low and up
(channels low then up) and the backward returns their gradients apart.

Four wrappers, one CUDA kernel launch each (csrc/head_convs.cu) on a CUDA
tensor, their plain PyTorch versions (`*_ref`) on a CPU tensor, each with
a `launches` count:

- `run_sep_fwd(low, up, k, pw)` (P1): a = pw(dw3x3(x)) and the batch
  (mean, var) of the f32 a;
- `run_head_fwd(a, bn, wc, bc)` (P2): logits = relu(BN(a)) wc^T + bc;
- `run_head_bwd(g, a, bn, wc)` (B1): (gu = (g wc) [u > 0], sums (Cm, 2) =
  [sum gu, sum gu * xhat], dWc, dbc);
- `run_sep_bwd(gu, a, low, up, pn, k, pw)` (B2): (g_low, g_up, dpw, dk),
  from ga, the BN's train backward of gu with pack pn.

Layouts: activations NHWC-contiguous; k (Ci, 9) f32 taps [dh * 3 + dw]; pw
(Cm, Ci), wc (nc, Cm) in the activation dtype; BN packs f32 (`ops.stem`'s
`_bn_pack` (C, 4) and `_bnbwd_pack` (C, 6)). Rounding points, the JAX
kernels': the depthwise in f32; its output t, the post-BN z, ga and the
weights rounded to the activation dtype as the products' operands, f32
sums; a, logits, gu and the input gradients stored in the activation
dtype; the moments and sums taken from the f32 values before that
rounding; gt (the gradient at t) f32 for the input gradient and dk. The
kernels take low and up with channel counts divisible by 8 and Cm
divisible by 16 up to 256, nc up to 32 (`fused_head_supported`).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..parallel.mesh import global_count, sync_moments, sync_sums
from .separable import launch_sep_fwd
from .stem import (EPS, SMEM_LIMIT, _DTYPE_CODE, _bn_bwd_apply, _bn_pack,
                   _bn_u_xh, _bnbwd_pack, _check_act, _count, _grad_sums,
                   _moments, _need, _pdt, _scratch, _stream, _tickets)

# the widest Cm and the most classes the kernels take (csrc/head_convs.cu
# kMaxCm, kKP; its entry points refuse wider ones)
MAX_CM, MAX_NC = 256, 32
# B2 in bf16 (sep_bwd_plan): tiles of SBW_TH x SBW_TW outputs (a halo of
# SBW_HALO pixels, SBW_HW wide), chunks of SBW_NC input channels, one CTA
# per chunk in each of at most SBW_CTAS // chunks groups; a ring of at most
# SBW_RING stages of two halo rows of gu and a beside SBW_FIXED bytes (pw's
# chunk, ga, t and x's chunk); the partials summed over groups of
# SBW_GROUP CTAs
SBW_TH, SBW_TW, SBW_HW, SBW_HALO, SBW_NC, SBW_CTAS = 6, 14, 16, 128, 64, 132
SBW_RING, SBW_GROUP = 4, 8
SBW_FIXED = MAX_CM * 128 + 5 * SBW_HALO * 128 + SBW_HALO * SBW_NC * 2
# B1 in bf16 (head_bwd_plan): tiles of HBW_TP pixels on at most HBW_CTAS
# CTAs, their partials summed over groups of HBW_GROUP CTAs; a ring of
# HBW_MIN_RING to HBW_RING slots, each a tile's 64-channel boxes of a
# (HBW_TP x 128 bytes) and its g, rounded up to 1 KB
HBW_TP, HBW_CTAS, HBW_GROUP, HBW_RING, HBW_MIN_RING = 64, 132, 12, 4, 3


def fused_head_supported(cl, cu, cm, nc) -> bool:
    """The widths the four kernels take (16-byte channel groups)."""
    return (cl % 8 == 0 and cu % 8 == 0 and cl > 0 and cu > 0
            and cm % 16 == 0 and 16 <= cm <= MAX_CM and 1 <= nc <= MAX_NC)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _as_op(t, dt, cdt):
    """t as an operand in the activation dtype dt, computed in cdt."""
    return t.to(dt).to(cdt)


def _taps(x, k, cdt):
    """Depthwise 3x3, pad 1, of NHWC x with taps k (C, 9), in cdt: NCHW
    view of the result."""
    c = x.shape[-1]
    return F.conv2d(x.to(cdt).permute(0, 3, 1, 2), k.to(cdt).reshape(c, 1, 3, 3),
                    None, 1, 1, 1, c)


def sep_fwd_ref(low, up, k, pw):
    """Plain P1: (a in the activation dtype, [sum a, sum a^2] (2, Cm) of the
    f32 a)."""
    dt, cdt = low.dtype, _pdt(low.dtype)
    t = _taps(torch.cat([low, up], -1), k, cdt).permute(0, 2, 3, 1)
    a = _as_op(t, dt, cdt) @ _as_op(pw, dt, cdt).t()
    return a.to(dt).contiguous(), torch.stack([a.sum((0, 1, 2)),
                                               (a * a).sum((0, 1, 2))])


def head_fwd_ref(a, bn, wc, bc, eps=EPS):
    """Plain P2: logits (N, H, W, nc) in a's dtype."""
    dt, cdt = a.dtype, _pdt(a.dtype)
    u, _ = _bn_u_xh(a.to(cdt), bn, eps)
    y = _as_op(torch.relu(u), dt, cdt) @ _as_op(wc, dt, cdt).t() + bc.to(cdt)
    return y.to(dt).contiguous()


def head_bwd_ref(g, a, bn, wc, eps=EPS):
    """Plain B1: (gu, sums (Cm, 2), dWc (nc, Cm), dbc (nc,))."""
    dt, cdt = g.dtype, _pdt(g.dtype)
    u, xh = _bn_u_xh(a.to(cdt), bn, eps)
    z = _as_op(torch.relu(u), dt, cdt)
    g32 = g.to(cdt)
    gu = (g32 @ _as_op(wc, dt, cdt)) * (u > 0.0)
    dwc = g32.reshape(-1, g.shape[-1]).t() @ z.reshape(-1, z.shape[-1])
    return gu.to(dt).contiguous(), _grad_sums(gu, xh), dwc, g32.sum((0, 1, 2))


def sep_bwd_ref(gu, a, low, up, pn, k, pw, eps=EPS):
    """Plain B2: (g_low, g_up in the activation dtype, dpw (Cm, Ci), dk
    (Ci, 9) f32); the depthwise's input and weight gradients by
    autograd."""
    dt, cdt = gu.dtype, _pdt(gu.dtype)
    cl, ci = low.shape[-1], low.shape[-1] + up.shape[-1]
    ga = _as_op(_bn_bwd_apply(gu.to(cdt), a.to(cdt), pn, eps), dt, cdt)
    gt = ga @ _as_op(pw, dt, cdt)
    with torch.enable_grad():
        x = torch.cat([low, up], -1).to(cdt).permute(0, 3, 1, 2) \
            .detach().requires_grad_()
        kk = k.to(cdt).reshape(ci, 1, 3, 3).detach().requires_grad_()
        t = F.conv2d(x, kk, None, 1, 1, 1, ci)
        gx, dk = torch.autograd.grad(t, (x, kk), gt.permute(0, 3, 1, 2))
    t = _as_op(t.detach().permute(0, 2, 3, 1), dt, cdt)
    dpw = ga.reshape(-1, ga.shape[-1]).t() @ t.reshape(-1, ci)
    gx = gx.permute(0, 2, 3, 1).to(dt)
    return (gx[..., :cl].contiguous(), gx[..., cl:].contiguous(), dpw,
            dk.reshape(ci, 9))


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _grid(kernel, dtype, n, h, w):
    """The x extent of the kernel's grid (the count of its CTA partials),
    as head_convs.cu tiles it: kernel 1 head_fwd, 2 head_bwd and 3 sep_bwd
    (float32; bf16 has head_bwd_plan and sep_bwd_plan)."""
    from .. import native

    return native.library().kdcc_head_grid(kernel, _DTYPE_CODE[dtype], n, h,
                                           w)


def _check_head(what, cm, nc):
    if cm % 16 or not 16 <= cm <= MAX_CM or not 1 <= nc <= MAX_NC:
        raise ValueError(f"{what}: the kernel takes Cm divisible by 16 up to "
                         f"{MAX_CM} and up to {MAX_NC} classes, got Cm {cm}, "
                         f"nc {nc}")


def _launch_head_fwd(a, bn, wc, bc, eps):
    from .. import native

    _check_act(a, "head_fwd")
    n, h, w, cm = a.shape
    nc = wc.shape[0]
    _check_head("head_fwd", cm, nc)
    _need(bn, "bn", (cm, 4), torch.float32, a.device)
    _need(wc, "wc", (nc, cm), a.dtype, a.device)
    _need(bc, "bc", (nc,), torch.float32, a.device)
    p = n * h * w
    grid = _grid(1, a.dtype, n, h, w)
    y = torch.empty((n, h, w, nc), dtype=a.dtype, device=a.device)
    err = native.library().kdcc_head_fwd(
        _DTYPE_CODE[a.dtype], a.data_ptr(), bn.data_ptr(), wc.data_ptr(),
        bc.data_ptr(), y.data_ptr(), p, cm, nc, float(eps), grid, _stream(a))
    native.check(err, f"head_fwd ({n},{h},{w},{cm}) -> {nc}")
    return y


@functools.lru_cache(maxsize=None)
def head_bwd_plan(p, cm, nc):
    """The bf16 B1 kernel's plan for p pixels of cm channels and nc classes,
    from the shape alone (mirrors csrc/head_convs.cu's hbw::plan; the
    kernel refuses another grid or scratch size): (CTAs, groups of the
    partials' first-level sum, f32 scratch floats, tickets, ring stages,
    shared memory bytes). min(tiles, HBW_CTAS) CTAs; a partial is dWc (nc
    x cm), the sums (cm x 2) and dbc (nc, rounded up to 4), one per CTA and
    one per group; a ring slot holds ceil(cm / 64) boxes and the tile's g;
    beside the ring, z's boxes, two g buffers [HBW_TP][MAX_NC + 8], wc
    [MAX_NC][cm + 8], the BN table (16 bytes a channel), the barriers and
    1 KB of alignment."""
    box = HBW_TP * 128
    nb = math.ceil(cm / 64)
    slot = nb * box + math.ceil(HBW_TP * nc * 2 / 1024) * 1024
    fixed = (1024 + nb * box + 2 * HBW_TP * (MAX_NC + 8) * 2
             + MAX_NC * (cm + 8) * 2 + cm * 16 + 8 * HBW_RING + 16)
    stages = min(HBW_RING, (SMEM_LIMIT - fixed) // slot)
    if p < 1 or stages < HBW_MIN_RING:
        raise ValueError(f"head_bwd takes no {p} pixels of {cm} <- {nc}")
    grid = min(math.ceil(p / HBW_TP), HBW_CTAS)
    groups = math.ceil(grid / HBW_GROUP)
    v = nc * cm + 2 * cm + math.ceil(nc / 4) * 4
    return grid, groups, (grid + groups) * v, groups + 1, stages, \
        fixed + stages * slot


HEAD_BWD = "head_bwd"


def _launch_head_bwd(g, a, bn, wc, eps):
    """(gu, sums (Cm, 2), dWc (nc, Cm), dbc (nc,)); bf16: one launch, the
    sums, dWc and dbc summed in the kernel."""
    from .. import native

    _check_act(g, "head_bwd")
    n, h, w, nc = g.shape
    cm = a.shape[-1]
    _check_head("head_bwd", cm, nc)
    _need(a, "a", (n, h, w, cm), g.dtype, g.device)
    _need(bn, "bn", (cm, 4), torch.float32, g.device)
    _need(wc, "wc", (nc, cm), g.dtype, g.device)
    p, dev = n * h * w, g.device
    f32 = dict(dtype=torch.float32, device=dev)
    gu = torch.empty_like(a)
    if g.dtype == torch.bfloat16:
        grid, _, floats, tickets, _, _ = head_bwd_plan(p, cm, nc)
        sums = torch.empty((cm, 2), **f32)
        dwc = torch.empty((nc, cm), **f32)
        dbc = torch.empty((nc,), **f32)
        err = native.library().kdcc_head_bwd_bf16(
            g.data_ptr(), a.data_ptr(), bn.data_ptr(), wc.data_ptr(),
            gu.data_ptr(), dwc.data_ptr(), sums.data_ptr(), dbc.data_ptr(),
            _scratch(dev, HEAD_BWD, floats).data_ptr(),
            _tickets(dev, HEAD_BWD, tickets).data_ptr(), p, cm, nc,
            float(eps), grid, floats, _stream(g))
        native.check(err, f"head_bwd ({n},{h},{w},{cm}) <- {nc}")
        return gu, sums, dwc, dbc
    grid = _grid(2, g.dtype, n, h, w)
    psum = torch.empty((grid, 2, cm), **f32)
    pwc = torch.empty((grid, nc, cm), **f32)
    pbc = torch.empty((grid, nc), **f32)
    err = native.library().kdcc_head_bwd(
        _DTYPE_CODE[g.dtype], g.data_ptr(), a.data_ptr(), bn.data_ptr(),
        wc.data_ptr(), gu.data_ptr(), psum.data_ptr(), pwc.data_ptr(),
        pbc.data_ptr(), p, cm, nc, float(eps), grid, _stream(g))
    native.check(err, f"head_bwd ({n},{h},{w},{cm}) <- {nc}")
    return gu, psum.sum(0).t(), pwc.sum(0), pbc.sum(0)


@functools.lru_cache(maxsize=None)
def sep_bwd_plan(n, h, w, ci, cm):
    """The bf16 B2 kernel's plan for a shape, from the shape alone (mirrors
    csrc/head_convs.cu's sbw::plan; the kernel refuses another grid or
    scratch size): (CTAs, chunks, groups of the partials' first-level sum,
    f32 scratch floats, tickets, ring stages). ceil(ci / SBW_NC) chunks,
    min(tiles, SBW_CTAS // chunks) CTAs a chunk (the chunks of one tile
    adjacent); each CTA leaves (cm + 9) x SBW_NC floats, each group one
    more; a stage is 2 x SBW_HW rows of gu and a, and the ring's mbarriers
    take 8 bytes a slot."""
    chunks = math.ceil(ci / SBW_NC)
    tiles = n * math.ceil(h / SBW_TH) * math.ceil(w / SBW_TW)
    gx = min(tiles, SBW_CTAS // chunks)
    stage = 2 * SBW_HW * cm * 4
    stages = min(SBW_RING, (SMEM_LIMIT - 1024 - SBW_FIXED - 8 * SBW_RING - 16)
                 // stage)
    if gx < 1 or stages < 2:
        raise ValueError(f"sep_bwd takes no ({n},{h},{w}) {ci} <- {cm}")
    groups = math.ceil(gx / SBW_GROUP)
    grid = gx * chunks
    return (grid, chunks, groups, (grid + chunks * groups) * (cm + 9) * SBW_NC,
            chunks * (groups + 1), stages)


SEP_BWD = "sep_bwd"


def _launch_sep_bwd(gu, a, low, up, pn, k, pw, eps):
    """(g_low, g_up, dpw (Cm, Ci), dk (Ci, 9)); bf16: one launch, dpw and dk
    summed in the kernel."""
    from .. import native

    _check_act(gu, "sep_bwd")
    n, h, w, cm = gu.shape
    cl, cu = low.shape[-1], up.shape[-1]
    ci, dev, dt = cl + cu, gu.device, gu.dtype
    _check_head("sep_bwd", cm, 1)
    if cl % 8 or cu % 8:
        raise ValueError(f"sep_bwd takes channel counts divisible by 8, got "
                         f"{cl} + {cu}")
    _need(a, "a", gu.shape, dt, dev)
    _need(low, "low", (n, h, w, cl), dt, dev)
    _need(up, "up", (n, h, w, cu), dt, dev)
    _need(pn, "pn", (cm, 6), torch.float32, dev)
    _need(k, "k", (ci, 9), torch.float32, dev)
    _need(pw, "pw", (cm, ci), dt, dev)
    g_low, g_up = torch.empty_like(low), torch.empty_like(up)
    if dt == torch.bfloat16:
        grid, _, _, floats, tickets, _ = sep_bwd_plan(n, h, w, ci, cm)
        dpw = torch.empty((cm, ci), dtype=torch.float32, device=dev)
        dk = torch.empty((ci, 9), dtype=torch.float32, device=dev)
        err = native.library().kdcc_sep_bwd_bf16(
            gu.data_ptr(), a.data_ptr(), low.data_ptr(), up.data_ptr(),
            pn.data_ptr(), k.data_ptr(), pw.data_ptr(), g_low.data_ptr(),
            g_up.data_ptr(), dpw.data_ptr(), dk.data_ptr(),
            _scratch(dev, SEP_BWD, floats).data_ptr(),
            _tickets(dev, SEP_BWD, tickets).data_ptr(), n, h, w, cl, cu, cm,
            float(eps), grid, floats, _stream(gu))
        native.check(err, f"sep_bwd ({n},{h},{w},{cl}+{cu}) <- {cm}")
        return g_low, g_up, dpw, dk
    grid = _grid(3, dt, n, h, w)
    pdpw = torch.empty((grid, cm, ci), dtype=torch.float32, device=dev)
    pdk = torch.empty((grid, 9, ci), dtype=torch.float32, device=dev)
    kt, pwt = k.t().contiguous(), pw.t().contiguous()
    err = native.library().kdcc_sep_bwd(
        _DTYPE_CODE[dt], gu.data_ptr(), a.data_ptr(), low.data_ptr(),
        up.data_ptr(), pn.data_ptr(), kt.data_ptr(),
        pwt.data_ptr(), g_low.data_ptr(), g_up.data_ptr(),
        pdpw.data_ptr(), pdk.data_ptr(), n, h, w, cl, cu, cm, float(eps),
        grid, _stream(gu))
    native.check(err, f"sep_bwd ({n},{h},{w},{cl}+{cu}) <- {cm}")
    return g_low, g_up, pdpw.sum(0), pdk.sum(0).t()


# ---------------------------------------------------------------------------
# the four passes (decoder.py:250, 265, 319, 340)
# ---------------------------------------------------------------------------

def run_sep_fwd(low, up, k, pw):
    """P1: (a, mean, var), a = pw(dw3x3(cat(low, up))) NHWC (N, H, W, Cm);
    on the card the kernel sums the moments and writes mean and var."""
    if low.device.type == "cpu":
        a, sums = sep_fwd_ref(low, up, k, pw)
        return (a, *_moments(sums, _count(a)))
    _need(k, "k", (low.shape[-1] + up.shape[-1], 9), torch.float32,
          low.device)
    a, mv = launch_sep_fwd(low, up, k.t().contiguous(), pw, 3, 1, True)
    run_sep_fwd.launches += 1
    return a, mv[0], mv[1]


def run_head_fwd(a, bn, wc, bc, eps=EPS):
    """P2: logits (N, H, W, nc) = relu(BN(a)) wc^T + bc."""
    if a.device.type == "cpu":
        return head_fwd_ref(a, bn, wc, bc, eps)
    out = _launch_head_fwd(a, bn, wc, bc, eps)
    run_head_fwd.launches += 1
    return out


def run_head_bwd(g, a, bn, wc, eps=EPS):
    """B1: (gu, sums (Cm, 2), dWc (nc, Cm), dbc (nc,))."""
    if g.device.type == "cpu":
        return head_bwd_ref(g, a, bn, wc, eps)
    out = _launch_head_bwd(g, a, bn, wc, eps)
    run_head_bwd.launches += 1
    return out


def run_sep_bwd(gu, a, low, up, pn, k, pw, eps=EPS):
    """B2: (g_low, g_up, dpw (Cm, Ci), dk (Ci, 9))."""
    if gu.device.type == "cpu":
        return sep_bwd_ref(gu, a, low, up, pn, k, pw, eps)
    out = _launch_sep_bwd(gu, a, low, up, pn, k, pw, eps)
    run_sep_bwd.launches += 1
    return out


PASSES = (run_sep_fwd, run_head_fwd, run_head_bwd, run_sep_bwd)
for _fn in PASSES:
    _fn.launches = 0


# ---------------------------------------------------------------------------
# the head (decoder.py:408-446)
# ---------------------------------------------------------------------------

HEAD_KEYS = ("k", "pw", "g", "b", "wc", "bc")


class _FusedDecoderHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, low, up, eps, group, *flat):
        p = dict(zip(HEAD_KEYS, flat))
        dt, pdt = low.dtype, _pdt(low.dtype)
        k = p["k"].to(pdt).contiguous()
        pw, wc = (p[key].to(dt).contiguous() for key in ("pw", "wc"))
        a, mean, var = run_sep_fwd(low, up, k, pw)
        # P1's moments over the global batch before P2 takes them
        mean, var = sync_moments(mean, var, float(_count(a)), group)
        bn = _bn_pack(mean, var, p["g"], p["b"])
        logits = run_head_fwd(a, bn, wc, p["bc"].to(pdt).contiguous(), eps)
        ctx.eps, ctx.group = eps, group
        ctx.save_for_backward(low, up, a, mean, var, k, pw, wc, *flat)
        ctx.mark_non_differentiable(mean, var)
        return logits, mean, var

    @staticmethod
    def backward(ctx, g_logits, *_):
        low, up, a, mean, var, k, pw, wc, *flat = ctx.saved_tensors
        p = dict(zip(HEAD_KEYS, flat))
        eps = ctx.eps
        bn = _bn_pack(mean, var, p["g"], p["b"])
        gu, s, dwc, dbc = run_head_bwd(g_logits.contiguous(), a, bn, wc, eps)
        # B1's sums (and count) over the global batch before B2's pack; the
        # BN's parameter gradients stay this rank's share
        sg = sync_sums(s, ctx.group)
        pn = _bnbwd_pack(mean, var, p["g"], sg[:, 0], sg[:, 1],
                         global_count(float(_count(a)), ctx.group))
        g_low, g_up, dpw, dk = run_sep_bwd(gu, a, low, up, pn, k, pw, eps)
        grads = {"k": dk, "pw": dpw, "g": s[:, 1], "b": s[:, 0], "wc": dwc,
                 "bc": dbc}
        return (g_low, g_up, None, None,
                *(grads[key].to(p[key].dtype) for key in HEAD_KEYS))


def fused_decoder_head(low, up, params, eps: float = EPS):
    """cat(low, up) -> sep(Ci -> Cm, 3x3, pad 1) -> train BN -> relu -> 1x1
    (Cm -> nc) + bias, without building the concat.

    low (N, H, W, Cl) and up (N, H, W, Cu) NHWC in the compute dtype (the
    channel order of the taps and pw is low then up). params: k (Ci, 9)
    depthwise taps [dh * 3 + dw], pw (Cm, Ci), g, b (Cm,) the BN's affine,
    wc (nc, Cm), bc (nc,); pw and wc are cast to the input's dtype, the rest
    computes in f32. Returns (logits (N, H, W, nc) NHWC in the input's
    dtype, (batch mean, biased batch var) of the BN's input). Gradients
    reach low, up and every parameter."""
    return fused_decoder_head_sharded(low, up, params, None, eps)


def fused_decoder_head_sharded(low, up, params, group, eps: float = EPS):
    """fused_decoder_head on this rank's rows of a batch sharded over
    `group` (the JAX package's fused_decoder_head_folded_sharded,
    decoder.py:478): the same four kernels on every rank, P1's moments
    all-reduced before P2 and B1's BN sums before B2 (global moments
    returned), the parameter gradients this rank's share. With a group of
    one rank (or None) no collective is called and the result is
    fused_decoder_head's, bit for bit."""
    outs = _FusedDecoderHead.apply(low.contiguous(), up.contiguous(),
                                   float(eps), group,
                                   *(params[key] for key in HEAD_KEYS))
    return outs[0], (outs[1], outs[2])
