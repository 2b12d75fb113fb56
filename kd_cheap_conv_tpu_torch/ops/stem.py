"""Train-mode BN-barrier passes and the fused MobileNetV2 stem (features[0..2]).

Counterpart of kd_cheap_conv_tpu/ops/pallas/stem.py. Every tensor is
NHWC-contiguous (the port's channels_last memory), unpadded: none of the
TPU's padded row/lane layout is carried over.

Six pass wrappers, a CUDA kernel launch each (csrc/bn_passes.cu, or for a
wide 1x1 csrc/wide_pw.cu) on a CUDA tensor, their plain PyTorch versions
(`*_ref`) on a CPU tensor:

- `run_bn_pw(x, bn, w, relu)`: BN + act of the previous layer applied to x,
  then the 1x1 conv w (Co, Ci); returns (y, mean, var), the moments of y
  for the next BN, or (y, None, None) with moments=False (an eval pass:
  the kernel takes no CTA partials);
- `run_bn_dw(x, bn, k, relu, dil=d)`, `run_bn_dw_s2(...)`: the same with a
  3x3 depthwise conv k (C, 9): stride 1, dilation d (1, 2 or 4: DW_DILATIONS), pad d; or
  stride 2, dilation 1, pad 1 (output (H + 1) // 2);
- `run_pw_bwd(gy, a_next, a_k, pn, bnk, w, relu_k)`,
  `run_dw_bwd(...)`, `run_dw_s2_bwd(...)`: the backward of one link
  [BN_k (+act) -> conv -> a_next] given gy = dL/du_next; return
  (gy_k, sums (C_k, 2) = [sum gy_k, sum gy_k * xhat_k], dW (Co, Ci) or
  dk (C, 9)).

BN packs are f32 (C, 4) [mean, var, gamma, beta] (`_bn_pack`) and, for the
backward, (C, 6) [mean, var, gamma, sum_g, sum_gx, 1/M] (`_bnbwd_pack`).
`bn=None` is the identity input BN (the IR chain's expand pass reads a
finished tensor; the JAX package passes `_identity_bn_eps` there), and
`pn=None` the identity next-BN backward (a_next is then not read; the JAX
package's `_bnbwd_identity` pack scales by rsqrt(1 + eps), 1 - 5e-6, which
the port does not reproduce). Activation: none (False), relu6 (True,
MobileNetV2) or plain relu ("relu", Xception), as the JAX `_act`
(stem.py:136). The backward convention is the JAX package's (stem.py:723):
gy_k is the gradient at BN_k's pre-activation output, the activation's mask
is applied by the pass that produces it.

Each 1x1 pass goes to one of two kernel families by a width guard
(`pw_narrow`): the narrow kernels of csrc/bn_passes.cu keep the whole
weight in shared memory (even widths up to PW_MAX_C, Ci x Co up to
PW_MAX_CICO: every 1x1 conv of the MobileNetV2 chains; in bf16 the
forward takes widths divisible by 8, `bn_pw_fwd_plan`, and both directions
multiply on the tensor cores, in f32 on CUDA-core FMAs); every wider pass
goes to the wide kernels of csrc/wide_pw.cu
(`run_bn_pw_wide`; the backward as two launches, `run_xpw_dgrad` for gy_k
and its sums and `run_xpw_wgrad` for dW), which stream the weight in K
chunks through the tensor cores (widths divisible by 8 up to XPW_MAX_C:
the Xception chains). A shape that neither takes raises.

Numerics: BN and the depthwise convs in f32; the 1x1 conv rounds its
operands (the post-BN activation and the weight, in the backward ga and z)
to the activation dtype and sums in f32, as the JAX kernel's matmuls do; y
and gy_k are stored in the activation dtype, the moments and sums are taken
in f32 before that rounding. The plain versions compute in f32 (f64 for
f64 inputs, which only the CPU takes). Each wrapper counts its kernel
launches in its `launches` attribute; the stride-1 depthwise wrappers
(`run_bn_dw`, `run_dw_bwd`) also by dilation, that is by kernel instance,
in `launches_by_dil`.

Three entry-conv wrappers (csrc/entry_convs.cu), for features[0].conv
(3x3 / stride 2 / pad 1, 3 -> C0) inside the chain:

- `run_f0(x, w0)`: x (N, H, W, 3) the image, w0 (C0, 3, 3, 3) -> (a0, mean,
  var), a0 (N, (H + 1) // 2, (W + 1) // 2, C0) in x's dtype and bn0's batch
  moments from the f32 conv values before they are rounded to that dtype;
- `run_f0_wgrad(gy0, a0, x, pn0)`: bn0's train backward of gy0 (the dw1
  link's gy_k) with pack pn0, rounded to the activation dtype, then dW0
  (C0, 3, 3, 3) f32;
- `run_f0_xgrad(gy0, a0, pn0, w0, x_shape)`: the image gradient.

The JAX kernels read a host-packed space-to-depth image (a TPU layout);
these read the NHWC image, and take any H and W (the JAX packing needs odd
sizes).

`fused_stem_f1f2(a0, params)` chains five passes into features[1..2] in
training mode as a torch.autograd.Function, the final bn5 (and its
backward) in torch, as the JAX package leaves it to XLA. With "w0" in
params (f0 mode) its input is the image and the entry-conv kernels run in
the chain: bn0's moments come from `run_f0`, its backward from
`run_f0_wgrad`, and `run_f0_xgrad` runs only when the image needs a
gradient. Without it (a0 mode) the input is the entry conv's output and
bn0's moments and backward run in torch.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

EPS = 1e-5
SMEM_LIMIT = 232_448
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/bn_passes.cu: the f32 1x1 passes stage PW_TILE (forward) /
# PW_BWD_TILE (backward) pixels per step on at most PW_GRID CTAs, PW_RP
# pixels x 2 channels per thread item; the narrow 1x1 kernels take even
# widths up to PW_MAX_C and Ci x Co up to PW_MAX_CICO. The depthwise passes
# take widths divisible by 8: the forward runs on one wave of DWF_CTAS CTAs
# (bn_dw_fwd_plan), the backward sizes its own grid to the card
# (dw_bwd_grid).
PW_TILE, PW_BWD_TILE, PW_GRID, PW_RP = 64, 32, 396, 4
PW_MAX_C, PW_MAX_CICO = 192, 6144
# The bf16 1x1 backward (one launch) walks PWB_TP-pixel tiles on one wave of
# at most PWB_CTAS CTAs and sums their partials in the kernel over groups of
# PWB_GROUP CTAs (pw_bwd_plan)
PWB_TP, PWB_CTAS, PWB_GROUP = 64, 132, 12
# The bf16 1x1 forward (one launch, bn_pw_fwd_plan) walks PWF_TP-pixel tiles
# on one wave of at most PWF_CTAS CTAs through a ring of at most
# PWF_MAX_STAGES staged tiles, and sums its moments in the kernel over
# groups of PWF_GROUP CTAs; widths divisible by 8
PWF_TP, PWF_CTAS, PWF_GROUP, PWF_MAX_STAGES = 128, 132, 12, 4
THREADS = 256
# the stride-1 depthwise passes' dilations: 1 and 2 (MobileNetV2; the
# Xception chains at OS16) and 4 (Xception's exit flow at OS8)
DW_DILATIONS = (1, 2, 4)
# The depthwise forward (bn_dw_fwd_plan): one wave of DWF_CTAS CTAs (two on
# each of the H100's 132 SMs, DWF_SMEM bytes of shared memory each) over
# the channel slices, a ring of DWF_RAW input windows each; a tile row
# holds 2 thread items of 8 outputs (stride 2: 4 of 2); the moments' sum
# goes over groups of DWF_GROUP CTAs
DWF_CTAS, DWF_SMEM, DWF_RAW, DWF_GROUP = 264, 115_712, 3, 24
# csrc/wide_pw.cu: widths divisible by 8 up to XPW_MAX_C; the grids come
# from kdcc_xpw_grid. Its bf16 forward (xpw_fwd_plan) tiles y in XPW_BM
# pixels x 64/128/256 output channels on one wave of XPW_CTAS CTAs; its bf16
# weight gradient (xpw_wgrad_plan) tiles dW in XPW_BM output x 64/128/256
# input channels and splits the pixels, in chunks of XPW_BK, over one wave
# of XPW_CTAS CTAs, at least XPW_MIN_CHUNKS chunks a split
XPW_MAX_C = 2048
XPW_BM, XPW_BK, XPW_CTAS, XPW_MIN_CHUNKS = 128, 64, 132, 8
XPW_SUM_GROUP = 12
ACTS = (False, True, "relu")
# csrc/entry_convs.cu: the f0 kernels take C0 % 8 == 0 up to F0_MAX_C; a tile
# is one row segment of THREADS // (C0 // 8) output pixels, grid-stride over
# at most F0_GRID CTAs
F0_MAX_C, F0_GRID = 64, 1056


def pw_fwd_smem_bytes(ci, co):
    """Dynamic shared memory of the 1x1 forward kernel (the .cu checks it)."""
    return 4 * (ci * co + PW_TILE * (ci + 1) + 4 * ci
                + 2 * (PW_TILE // PW_RP) * co)


def pw_bwd_smem_bytes(ci, co):
    """Dynamic shared memory of the 1x1 backward kernel."""
    return 4 * (co * ci + PW_BWD_TILE * co + 2 * PW_BWD_TILE * ci + 5 * co
                + 4 * ci + 2 * (PW_BWD_TILE // PW_RP) * ci)


# ---------------------------------------------------------------------------
# helpers (stem.py:574-588, 732-753, 1037-1046)
# ---------------------------------------------------------------------------

def _pdt(dt):
    """Dtype of BN statistics and of the plain versions' arithmetic."""
    return torch.float64 if dt == torch.float64 else torch.float32


def _act(u, relu):
    if relu == "relu":
        return u.clamp_min(0.0)
    return u.clamp(0.0, 6.0) if relu else u


def _act_grad(u, relu):
    if relu == "relu":
        return (u > 0.0).to(u.dtype)
    return ((u > 0.0) & (u < 6.0)).to(u.dtype)


def _act_code(relu):
    """The kernels' activation argument: 0 none, 1 relu6, 2 relu."""
    return 2 if relu == "relu" else int(bool(relu))


def _bn_pack(mean, var, gamma, beta):
    return torch.stack([mean, var, gamma.to(mean.dtype),
                        beta.to(mean.dtype)], 1).contiguous()


def _bnbwd_pack(mean, var, gamma, sum_g, sum_gx, count):
    inv = torch.full_like(mean, 1.0 / count)
    return torch.stack([mean, var, gamma.to(mean.dtype), sum_g, sum_gx, inv],
                       1).contiguous()


def _moments(sums, count):
    """Batch mean and biased variance E[y^2] - E[y]^2 from [sum, sumsq]."""
    mean = sums[0] / count
    return mean, sums[1] / count - mean * mean


def _inv_std(var, eps):
    """1 / sqrt(var + eps), correctly rounded (the kernels compute it so,
    and so their relu6 masks are the plain versions', bit for bit)."""
    return 1.0 / torch.sqrt(var + eps)


def _bn_u_xh(a, bn, eps):
    """(u, xhat) of BN pack bn (C, 4) on channels-last a; None: identity."""
    if bn is None:
        return a, a
    mu, var, g, b = bn.to(a.dtype).unbind(1)
    xh = (a - mu) * _inv_std(var, eps)
    return xh * g + b, xh


def _bn_bwd_apply(gy, a, p, eps):
    """Train-mode BN backward with pack p (C, 6); None: identity."""
    if p is None:
        return gy
    mu, var, g, sg, sgx, im = p.to(gy.dtype).unbind(1)
    inv = _inv_std(var, eps)
    xh = (a - mu) * inv
    return g * inv * (gy - sg * im - xh * (sgx * im))


def _affine(a, m, v, g, b, eps):
    """Train-mode BN with known batch moments on a large tensor, in the
    moments' dtype: (a - m) * (rsqrt(v + eps) * g) + b in two fused passes."""
    return torch.addcmul(b.to(m.dtype), a - m, torch.rsqrt(v + eps) * g)


def _bn_bwd_affine(gz, d, inv, gamma, sum_g, sum_gx, count):
    """Train-mode BN backward on a large tensor: gamma * inv * (gz - sum_g/M
    - xhat * sum_gx/M) with xhat = d * inv, d = a - mean, written as one
    per-channel affine map of (gz, d): two fused passes."""
    k = gamma * inv
    return torch.addcmul(torch.addcmul(-k * sum_g / count, gz, k), d,
                         -k * inv * sum_gx / count)


def _bn_train_bwd(gz, a, m, v, gamma, eps):
    """The same, taking the sums over gz itself (the finishing BNs, whose
    cotangent comes from outside the chain): (d input, sum_g, sum_gx)."""
    inv = torch.rsqrt(v + eps)
    d = a - m
    sg = gz.sum((0, 1, 2), dtype=d.dtype)
    sgx = (gz * d).sum((0, 1, 2)) * inv
    return _bn_bwd_affine(gz, d, inv, gamma, sg, sgx, float(_count(a))), sg, sgx


def _check_args(relu, dil=1):
    if relu not in ACTS:
        raise ValueError(f"the BN-barrier passes take no activation (False), "
                         f"relu6 (True) or 'relu', got {relu!r}")
    if dil not in DW_DILATIONS:
        raise ValueError(f"the BN-barrier passes take a dilation in "
                         f"{DW_DILATIONS} (stride 1), got {dil}")


def _count(t):
    return t.numel() // t.shape[-1]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _channel_sums(y):
    return torch.stack([y.sum((0, 1, 2)), (y * y).sum((0, 1, 2))])


def bn_pw_ref(x, bn, w, relu, eps=EPS):
    """Plain 1x1 forward pass: (y in x's dtype, [sum y, sum y^2] (2, Co))."""
    cdt = _pdt(x.dtype)
    u, _ = _bn_u_xh(x.to(cdt), bn, eps)
    h = _act(u, relu).to(x.dtype).to(cdt)
    y = h @ w.to(x.dtype).to(cdt).t()
    return y.to(x.dtype), _channel_sums(y)


def bn_dw_ref(x, bn, k, relu, eps=EPS, stride=1, dil=1):
    """Plain 3x3 depthwise forward pass (pad = dilation `dil`, `stride`)."""
    cdt = _pdt(x.dtype)
    c = x.shape[-1]
    u, _ = _bn_u_xh(x.to(cdt), bn, eps)
    y = F.conv2d(_act(u, relu).permute(0, 3, 1, 2),
                 k.to(cdt).reshape(c, 1, 3, 3), None, stride, dil, dil,
                 c).permute(0, 2, 3, 1)
    return y.to(x.dtype).contiguous(), _channel_sums(y)


def _grad_sums(gu, xh):
    return torch.stack([gu.sum((0, 1, 2)), (gu * xh).sum((0, 1, 2))], 1)


def _pw_bwd_operands(gy, a_next, a_k, pn, bnk, eps):
    """(ga, u_k, xhat_k) of a 1x1 backward link: ga the next BN's backward
    of gy, rounded to the activation dtype (the operand of both products),
    and BN_k of a_k recomputed."""
    dt, cdt = gy.dtype, _pdt(gy.dtype)
    ga = _bn_bwd_apply(gy.to(cdt), None if pn is None else a_next.to(cdt),
                       pn, eps).to(dt).to(cdt)
    return (ga, *_bn_u_xh(a_k.to(cdt), bnk, eps))


def _pw_dgrad(ga, u, xh, w, relu_k, dt):
    gu = ga @ w.to(dt).to(ga.dtype)
    if relu_k:
        gu = gu * _act_grad(u, relu_k)
    return gu.to(dt), _grad_sums(gu, xh)


def _pw_wgrad(ga, u, relu_k, dt):
    z = _act(u, relu_k).to(dt).to(u.dtype)
    return ga.reshape(-1, ga.shape[-1]).t() @ z.reshape(-1, z.shape[-1])


def pw_dgrad_ref(gy, a_next, a_k, pn, bnk, w, relu_k, eps=EPS):
    """Plain 1x1 backward link, input side: (gy_k, sums (Ci, 2))."""
    ga, u, xh = _pw_bwd_operands(gy, a_next, a_k, pn, bnk, eps)
    return _pw_dgrad(ga, u, xh, w, relu_k, gy.dtype)


def pw_wgrad_ref(gy, a_next, a_k, pn, bnk, w, relu_k, eps=EPS):
    """Plain 1x1 backward link, weight side: dW (Co, Ci) f32 from ga and
    z = act(u_k), both rounded to the activation dtype."""
    ga, u, _ = _pw_bwd_operands(gy, a_next, a_k, pn, bnk, eps)
    return _pw_wgrad(ga, u, relu_k, gy.dtype)


def pw_bwd_ref(gy, a_next, a_k, pn, bnk, w, relu_k, eps=EPS):
    """Plain 1x1 backward link: (gy_k, sums (Ci, 2), dW (Co, Ci))."""
    ga, u, xh = _pw_bwd_operands(gy, a_next, a_k, pn, bnk, eps)
    return (*_pw_dgrad(ga, u, xh, w, relu_k, gy.dtype),
            _pw_wgrad(ga, u, relu_k, gy.dtype))


def dw_bwd_ref(gy, a_next, a_k, pn, bnk, k, relu_k, eps=EPS, stride=1,
               dil=1):
    """Plain 3x3 depthwise backward link: (gy_k, sums (C, 2), dk (C, 9)),
    the conv's input and weight gradients by autograd."""
    dt, cdt = gy.dtype, _pdt(gy.dtype)
    c = gy.shape[-1]
    ga = _bn_bwd_apply(gy.to(cdt), a_next.to(cdt), pn, eps)
    u, xh = _bn_u_xh(a_k.to(cdt), bnk, eps)
    with torch.enable_grad():
        h = _act(u, relu_k).permute(0, 3, 1, 2).detach().requires_grad_()
        kk = k.to(cdt).reshape(c, 1, 3, 3).detach().requires_grad_()
        y = F.conv2d(h, kk, None, stride, dil, dil, c)
        gh, dk = torch.autograd.grad(y, (h, kk), ga.permute(0, 3, 1, 2))
    gu = gh.permute(0, 2, 3, 1)
    if relu_k:
        gu = gu * _act_grad(u, relu_k)
    return gu.to(dt).contiguous(), _grad_sums(gu, xh), dk.reshape(c, 9)


def f0_ref(x, w0):
    """Plain entry conv 3x3 / stride 2 / pad 1: (a0 in x's dtype, [sum a0,
    sum a0^2] (2, C0) of the values before that rounding)."""
    cdt = _pdt(x.dtype)
    y = F.conv2d(x.to(cdt).permute(0, 3, 1, 2), w0.to(x.dtype).to(cdt), None,
                 2, 1).permute(0, 2, 3, 1)
    return y.to(x.dtype).contiguous(), _channel_sums(y)


def _f0_ga(gy, a0, pn, eps):
    """bn0's train backward, rounded to the activation dtype as the JAX
    kernels round the operands of their products."""
    dt, cdt = gy.dtype, _pdt(gy.dtype)
    ga = _bn_bwd_apply(gy.to(cdt), a0.to(cdt), pn, eps)
    return ga.to(dt).to(cdt).permute(0, 3, 1, 2)


def f0_wgrad_ref(gy, a0, x, pn, eps=EPS):
    """Plain dW0 (C0, 3, 3, 3): the conv's weight gradient of bn0's
    backward."""
    cdt = _pdt(gy.dtype)
    c0 = gy.shape[-1]
    return torch.nn.grad.conv2d_weight(
        x.to(cdt).permute(0, 3, 1, 2), (c0, 3, 3, 3), _f0_ga(gy, a0, pn, eps),
        2, 1)


def f0_xgrad_ref(gy, a0, pn, w0, x_shape, eps=EPS):
    """Plain image gradient (N, H, W, 3) in gy's dtype."""
    dt, cdt = gy.dtype, _pdt(gy.dtype)
    n, h, w, ci = x_shape
    dx = torch.nn.grad.conv2d_input((n, ci, h, w), w0.to(dt).to(cdt),
                                    _f0_ga(gy, a0, pn, eps), 2, 1)
    return dx.permute(0, 2, 3, 1).to(dt).contiguous()


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check_act(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel: it takes CUDA "
                         f"tensors, got {x.device} (the wrappers that route "
                         f"a CPU tensor take it to the plain version)")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what} takes float32 or bfloat16 activations, got "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what} takes NHWC-contiguous 4-D tensors")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{what}: {x.numel()} elements exceed the kernel's "
                         f"32-bit pixel index")


def _need(t, name, shape, dtype, device):
    if t is None:
        return
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(x):
    idx = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    return torch.cuda.current_stream(idx).cuda_stream


def _pw_grid(p, tile):
    return min(math.ceil(p / tile), PW_GRID)


def pw_narrow(ci, co):
    """The width guard of the 1x1 passes: True where the narrow kernels of
    csrc/bn_passes.cu take the link (forward and backward alike)."""
    return (ci % 2 == 0 and co % 2 == 0 and max(ci, co) <= PW_MAX_C
            and ci * co <= PW_MAX_CICO)


def _check_pw_wide(what, ci, co):
    if ci % 8 or co % 8 or max(ci, co) > XPW_MAX_C:
        raise ValueError(f"{what}: neither 1x1 kernel takes {ci}->{co}: the "
                         f"narrow ones take even widths up to {PW_MAX_C} and "
                         f"Ci x Co up to {PW_MAX_CICO}, the wide ones widths "
                         f"divisible by 8 up to {XPW_MAX_C}")


def _check_dw_width(what, c):
    if c % 8:
        raise ValueError(f"{what}: the kernel takes a width divisible by 8, "
                         f"got {c}")


def _partials(moments, grid, c, dev):
    """A forward pass's CTA partials (grid, 2, c), None without moments."""
    return torch.empty((grid, 2, c), dtype=torch.float32,
                       device=dev) if moments else None


def _partial_sums(part):
    return None if part is None else part.sum(0)


def _r16(c):
    return (c + 15) // 16 * 16


@functools.lru_cache(maxsize=None)
def bn_pw_fwd_plan(p, ci, co):
    """The bf16 1x1 forward kernel's plan for P = p pixels, ci -> co, from
    the shape alone (mirrors csrc/bn_passes.cu's npf::plan; the kernel
    refuses another grid or scratch size): (CTAs, groups of the moments'
    first-level sum, f32 scratch floats, ring stages). A CTA holds h
    (PWF_TP x (r16(ci) + 8)) and W (r16(co) x the same) in bf16, a staging
    tile of y (PWF_TP rows of co / 8 16-byte units, made odd), the tile's
    sums (8 x 2 x co f32) and as many staged tiles of x as fit, at most
    PWF_MAX_STAGES; each CTA leaves a (2, co) partial, each group one
    more."""
    if (ci % 8 or co % 8 or not 8 <= min(ci, co) or max(ci, co) > PW_MAX_C
            or ci * co > PW_MAX_CICO):
        raise ValueError(f"bn_pw's bf16 kernel takes widths divisible by 8 "
                         f"up to {PW_MAX_C} and Ci x Co up to {PW_MAX_CICO}, "
                         f"got {ci}->{co}")
    lh, ly = _r16(ci) + 8, (co // 8) | 1
    fixed = (2 * (PWF_TP + _r16(co)) * lh + PWF_TP * ly * 16
             + (PWF_TP // 16) * 2 * co * 4 + 16)
    stages = min(PWF_MAX_STAGES, (SMEM_LIMIT - fixed) // (PWF_TP * ci * 2))
    grid = min(math.ceil(p / PWF_TP), PWF_CTAS)
    groups = math.ceil(grid / PWF_GROUP)
    return grid, groups, (grid + groups) * 2 * co, stages


BN_PW_FWD = "bn_pw_fwd"


def _launch_bn_pw(x, bn, w, relu, eps, moments):
    """(y, mean, var), or (y, None, None) without moments; bf16: one launch,
    the moments summed and finished in the kernel."""
    from .. import native

    _check_act(x, "bn_pw")
    n, h, wd, ci = x.shape
    co = w.shape[0]
    dev = x.device
    _need(bn, "bn", (ci, 4), torch.float32, dev)
    _need(w, "w", (co, ci), x.dtype, dev)
    p = n * h * wd
    if x.dtype == torch.bfloat16:
        grid, groups, floats, _ = bn_pw_fwd_plan(p, ci, co)
        y = torch.empty((n, h, wd, co), dtype=x.dtype, device=dev)
        mv = scratch = tickets = None
        if moments:
            mv = torch.empty((2, co), dtype=torch.float32, device=dev)
            scratch = _scratch(dev, BN_PW_FWD, floats)
            tickets = _tickets(dev, BN_PW_FWD, groups + 1)
        err = native.library().kdcc_bn_pw_fwd_bf16(
            x.data_ptr(), _ptr(bn), w.data_ptr(), y.data_ptr(), _ptr(scratch),
            _ptr(mv), _ptr(tickets), p, ci, co, _act_code(relu), float(eps),
            grid, floats, _stream(x))
        native.check(err, f"bn_pw ({n},{h},{wd},{ci}) -> {co}")
        return (y, *mv.unbind(0)) if moments else (y, None, None)
    smem = pw_fwd_smem_bytes(ci, co)
    if smem > SMEM_LIMIT:
        raise ValueError(f"bn_pw: {ci}->{co} channels need {smem} bytes of "
                         f"shared memory")
    grid = _pw_grid(p, PW_TILE)
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=dev)
    part = _partials(moments, grid, co, dev)
    err = native.library().kdcc_bn_pw_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), _ptr(bn), w.data_ptr(),
        y.data_ptr(), _ptr(part), p, ci, co, _act_code(relu), float(eps),
        grid, smem, _stream(x))
    native.check(err, f"bn_pw ({n},{h},{wd},{ci}) -> {co}")
    return _with_moments(y, _partial_sums(part))


class DwFwdPlan(NamedTuple):
    grid: int            # CTAs along x (c / cs slices along y)
    cs: int              # channels a CTA owns
    groups: int          # groups of the moments' first-level sum
    scratch_floats: int  # f32 partials: (grid + groups) x 2 x c
    tickets: int         # int32 tickets: c / cs x (groups + 1)
    th: int              # output rows a tile


def _dwf_win(stride, dil, t):
    return t + 2 * dil if stride == 1 else 2 * t + 1


def _dwf_strips(stride):
    """(thread items a tile row, outputs an item)."""
    return (2, 8) if stride == 1 else (4, 2)


def _dwf_tile_w(stride):
    return math.prod(_dwf_strips(stride))


def _dwf_smem(stride, dil, th, cs, esize):
    """Dynamic shared memory of a depthwise forward CTA: DWF_RAW raw
    buffers and the f32 h of a tile's input window, or the end's reduction
    and its adder's flag."""
    return max(_dwf_win(stride, dil, th) * _dwf_win(stride, dil,
                                                    _dwf_tile_w(stride))
               * cs * (DWF_RAW * esize + 4), 2 * THREADS * 16 + 16)


@functools.lru_cache(maxsize=None)
def bn_dw_fwd_plan(n, h, w, c, stride, dil, esize):
    """The depthwise forward kernel's plan for a shape, from the shape
    alone (mirrors csrc/bn_passes.cu's dwf::plan; the kernel refuses
    another grid or scratch size): the widest channel slice cs = 4 G (G <=
    16 dividing c / 4, whole 16-byte copies) whose tile fits DWF_SMEM,
    with th output rows (the rows whose items the threads hold at once,
    fewer where the window does not fit), and as many CTAs along x as one
    wave holds for the c / cs slices along y, at most one a tile."""
    tw = _dwf_tile_w(stride)
    for g in range(16, 0, -1):
        cs = 4 * g
        if (c // 4) % g or (cs * esize) % 16:
            continue
        th = max(1, THREADS // g // _dwf_strips(stride)[0])
        while th > 1 and _dwf_smem(stride, dil, th, cs, esize) > DWF_SMEM:
            th -= 1
        if _dwf_smem(stride, dil, th, cs, esize) > DWF_SMEM:
            continue
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        tiles = n * math.ceil(ho / th) * math.ceil(wo / tw)
        slices = c // cs
        grid = max(1, min(tiles, DWF_CTAS // slices))
        groups = math.ceil(grid / DWF_GROUP)
        return DwFwdPlan(grid, cs, groups, (grid + groups) * 2 * c,
                         slices * (groups + 1), th)
    raise ValueError(f"bn_dw takes no ({n},{h},{w},{c}) at stride {stride}")


BN_DW_FWD = "bn_dw_fwd"


def _launch_bn_dw(x, bn, k, relu, eps, stride, dil, moments):
    """(y, mean, var), or (y, None, None) without moments: one launch,
    the moments summed and finished in the kernel."""
    from .. import native

    _check_act(x, "bn_dw")
    n, h, w, c = x.shape
    dev = x.device
    _need(bn, "bn", (c, 4), torch.float32, dev)
    _need(k, "k", (c, 9), torch.float32, dev)
    _check_dw_width("bn_dw", c)
    if x.data_ptr() % 16:
        raise ValueError("bn_dw copies 16 bytes at a time: x must be 16-byte "
                         "aligned")
    pl = bn_dw_fwd_plan(n, h, w, c, stride, dil, x.element_size())
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    y = torch.empty((n, ho, wo, c), dtype=x.dtype, device=dev)
    mv = scratch = tickets = None
    if moments:
        mv = torch.empty((2, c), dtype=torch.float32, device=dev)
        scratch = _scratch(dev, BN_DW_FWD, pl.scratch_floats)
        tickets = _tickets(dev, BN_DW_FWD, pl.tickets)
    err = native.library().kdcc_bn_dw_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), _ptr(bn), k.data_ptr(),
        y.data_ptr(), _ptr(scratch), _ptr(mv), _ptr(tickets), n, h, w, c,
        stride, dil, _act_code(relu), float(eps), pl.grid,
        pl.scratch_floats, _stream(x))
    native.check(err, f"bn_dw stride {stride} dilation {dil} "
                      f"({n},{h},{w},{c})")
    return (y, *mv.unbind(0)) if moments else (y, None, None)


def _check_pw_bwd(what, gy, a_next, a_k, pn, bnk, w):
    """A 1x1 backward link's arguments -> (n, h, w, ci, co)."""
    _check_act(gy, what)
    n, h, wd, co = gy.shape
    ci = a_k.shape[-1]
    dev, dt = gy.device, gy.dtype
    if pn is not None:
        _need(a_next, "a_next", gy.shape, dt, dev)
    _need(pn, "pn", (co, 6), torch.float32, dev)
    _need(a_k, "a_k", (n, h, wd, ci), dt, dev)
    _need(bnk, "bnk", (ci, 4), torch.float32, dev)
    _need(w, "w", (co, ci), dt, dev)
    return n, h, wd, ci, co


def pw_bwd_plan(p, ci, co):
    """The bf16 1x1 backward kernel's plan for P = p pixels, ci <- co, from
    the shape alone (mirrors csrc/bn_passes.cu's nbw::plan; the kernel
    refuses another scratch size): (CTAs, groups of the partials' first-level
    sum, f32 scratch floats). Each CTA leaves a partial of co ci + 2 ci
    floats (dW, then the sums), each group one more."""
    grid = min(math.ceil(p / PWB_TP), PWB_CTAS)
    groups = math.ceil(grid / PWB_GROUP)
    return grid, groups, (grid + groups) * (co * ci + 2 * ci)


# per (device, kernel): the in-kernel sums' tickets (zero between launches:
# the CTA that takes the last ticket resets it; launches of one device run
# in stream order) and a f32 scratch, kept and grown to the largest call
_TICKETS, _SCRATCH = {}, {}


def _tickets(dev, kernel, count=256):
    t = _TICKETS.get((dev, kernel))
    if t is None or t.numel() < count:
        t = _TICKETS[dev, kernel] = torch.zeros(max(count, 256),
                                                dtype=torch.int32, device=dev)
    return t


def _scratch(dev, kernel, floats):
    buf = _SCRATCH.get((dev, kernel))
    if buf is None or buf.numel() < floats:
        buf = _SCRATCH[dev, kernel] = torch.empty(
            floats, dtype=torch.float32, device=dev)
    return buf


PW_BWD = "pw_bwd"


def _launch_pw_bwd(gy, a_next, a_k, pn, bnk, w, relu_k, eps):
    from .. import native

    n, h, wd, ci, co = _check_pw_bwd("pw_bwd", gy, a_next, a_k, pn, bnk, w)
    dev, dt = gy.device, gy.dtype
    p = n * h * wd
    gyk = torch.empty_like(a_k)
    if dt == torch.bfloat16:   # one launch: dW and the sums summed in it
        _, _, floats = pw_bwd_plan(p, ci, co)
        dw = torch.empty((co, ci), dtype=torch.float32, device=dev)
        sums = torch.empty((ci, 2), dtype=torch.float32, device=dev)
        err = native.library().kdcc_pw_bwd_bf16(
            gy.data_ptr(), _ptr(a_next if pn is not None else None),
            _ptr(pn), a_k.data_ptr(), _ptr(bnk), w.data_ptr(),
            gyk.data_ptr(), dw.data_ptr(), sums.data_ptr(),
            _scratch(dev, PW_BWD, floats).data_ptr(),
            _tickets(dev, PW_BWD).data_ptr(), p, ci, co, _act_code(relu_k),
            float(eps), floats, _stream(gy))
        native.check(err, f"pw_bwd ({n},{h},{wd}) {ci}<-{co}")
        return gyk, sums, dw
    smem = pw_bwd_smem_bytes(ci, co)
    if smem > SMEM_LIMIT:
        raise ValueError(f"pw_bwd: {ci}->{co} channels need {smem} bytes of "
                         f"shared memory")
    grid = _pw_grid(p, PW_BWD_TILE)
    psum = torch.empty((grid, 2, ci), dtype=torch.float32, device=dev)
    pw = torch.empty((grid, co, ci), dtype=torch.float32, device=dev)
    err = native.library().kdcc_pw_bwd(
        _DTYPE_CODE[dt], gy.data_ptr(), _ptr(a_next if pn is not None
                                             else None), _ptr(pn),
        a_k.data_ptr(), _ptr(bnk), w.data_ptr(), gyk.data_ptr(),
        psum.data_ptr(), pw.data_ptr(), p, ci, co, _act_code(relu_k),
        float(eps), grid, smem, _stream(gy))
    native.check(err, f"pw_bwd ({n},{h},{wd}) {ci}<-{co}")
    return gyk, psum.sum(0).t(), pw.sum(0)


# csrc/wide_pw.cu's kernels, as kdcc_xpw_grid numbers them
XPW_FWD, XPW_DGRAD, XPW_WGRAD = 0, 1, 2


def _xpw_grid(kernel, dt, p, ci, co):
    from .. import native

    return native.library().kdcc_xpw_grid(kernel, _DTYPE_CODE[dt], p, ci, co)


def xpw_fwd_plan(p, co):
    """The bf16 wide forward kernel's plan for P = p pixels and co output
    channels, from the shape alone (mirrors csrc/wide_pw.cu's xbw::fwd_*):
    (tile width BN, CTAs along x, column blocks along y, groups of the
    moments' first-level sum). Each CTA keeps one column block of BN output
    channels over every gridDim.x-th tile of XPW_BM pixels and leaves its
    moments as a (2, co) partial; each group of XPW_SUM_GROUP CTAs one
    more (xpw_fwd_scratch_floats), summed in the kernel."""
    bn = 64 if co <= 64 else 128 if co <= 128 else 256
    blocks = math.ceil(co / bn)
    grid = min(math.ceil(p / XPW_BM), max(XPW_CTAS // blocks, 1))
    return bn, grid, blocks, math.ceil(grid / XPW_SUM_GROUP)


def xpw_fwd_scratch_floats(p, co):
    """f32 scratch of the bf16 wide forward's moments: (CTAs + groups, 2,
    co)."""
    _, grid, _, groups = xpw_fwd_plan(p, co)
    return (grid + groups) * 2 * co


def _launch_bn_pw_wide(x, bn, w, relu, eps, moments):
    from .. import native

    _check_act(x, "bn_pw_wide")
    n, h, wd, ci = x.shape
    co = w.shape[0]
    _need(bn, "bn", (ci, 4), torch.float32, x.device)
    _need(w, "w", (co, ci), x.dtype, x.device)
    _check_pw_wide("bn_pw_wide", ci, co)
    p, dev = n * h * wd, x.device
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=dev)
    if x.dtype == torch.bfloat16:   # mean and variance from the kernel
        grid = xpw_fwd_plan(p, co)[1]
        mv = (torch.empty((2, co), dtype=torch.float32, device=dev)
              if moments else None)
        part = (_scratch(dev, XPW_FWD, xpw_fwd_scratch_floats(p, co))
                if moments else None)
        extra = (_ptr(mv), _tickets(dev, XPW_FWD).data_ptr())
    else:                           # CTA partials, summed here
        grid = _xpw_grid(XPW_FWD, x.dtype, p, ci, co)
        part = _partials(moments, grid, co, dev)
        extra = (None, None)
    err = native.library().kdcc_xpw_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), _ptr(bn), w.data_ptr(),
        y.data_ptr(), _ptr(part), *extra, p, ci, co, _act_code(relu),
        float(eps), grid, _stream(x))
    native.check(err, f"bn_pw_wide ({n},{h},{wd},{ci}) -> {co}")
    if x.dtype == torch.bfloat16:
        return (y, *mv.unbind(0)) if moments else (y, None, None)
    return _with_moments(y, _partial_sums(part))


def _launch_xpw_dgrad(gy, a_next, a_k, pn, bnk, w, relu_k, eps):
    from .. import native

    n, h, wd, ci, co = _check_pw_bwd("xpw_dgrad", gy, a_next, a_k, pn, bnk,
                                     w)
    _check_pw_wide("xpw_dgrad", ci, co)
    p = n * h * wd
    grid = _xpw_grid(XPW_DGRAD, gy.dtype, p, ci, co)
    gyk = torch.empty_like(a_k)
    psum = torch.empty((grid, 2, ci), dtype=torch.float32, device=gy.device)
    err = native.library().kdcc_xpw_dgrad(
        _DTYPE_CODE[gy.dtype], gy.data_ptr(),
        _ptr(a_next if pn is not None else None), _ptr(pn), a_k.data_ptr(),
        _ptr(bnk), w.data_ptr(), gyk.data_ptr(), psum.data_ptr(), p, ci, co,
        _act_code(relu_k), float(eps), grid, _stream(gy))
    native.check(err, f"xpw_dgrad ({n},{h},{wd}) {ci}<-{co}")
    return gyk, psum.sum(0).t()


def xpw_wgrad_plan(p, ci, co):
    """The bf16 weight-gradient kernel's plan for P = p pixels, ci -> co:
    (tile width BN, tiles, pixel splits, XPW_BK-pixel chunks a split), from
    the shape alone (mirrors csrc/wide_pw.cu's xbw::wgrad_*; the kernel
    refuses other splits). The splits' f32 fragments, (tiles, splits,
    XPW_BM, BN), are summed in the kernel; a single split writes dW
    directly."""
    bn = 64 if ci <= 64 else 128 if ci <= 128 else 256
    tiles = math.ceil(co / XPW_BM) * math.ceil(ci / bn)
    chunks = math.ceil(p / XPW_BK)
    cps = max(math.ceil(chunks / max(XPW_CTAS // tiles, 1)), XPW_MIN_CHUNKS)
    return bn, tiles, math.ceil(chunks / cps), cps


def xpw_wgrad_scratch_floats(p, ci, co):
    """f32 scratch the bf16 weight gradient's splits leave for its sum."""
    bn, tiles, splits, _ = xpw_wgrad_plan(p, ci, co)
    return tiles * splits * XPW_BM * bn if splits > 1 else 0


def _launch_xpw_wgrad(gy, a_next, a_k, pn, bnk, w, relu_k, eps):
    from .. import native

    n, h, wd, ci, co = _check_pw_bwd("xpw_wgrad", gy, a_next, a_k, pn, bnk,
                                     w)
    _check_pw_wide("xpw_wgrad", ci, co)
    p, dt, dev = n * h * wd, gy.dtype, gy.device
    if dt == torch.bfloat16:   # dW summed in the kernel
        splits = xpw_wgrad_plan(p, ci, co)[2]
        out = torch.empty((co, ci), dtype=torch.float32, device=dev)
        scratch = torch.empty(xpw_wgrad_scratch_floats(p, ci, co),
                              dtype=torch.float32, device=dev)
        extra = (scratch.data_ptr() if splits > 1 else None,
                 _tickets(dev, XPW_WGRAD).data_ptr())
    else:                      # one partial per split, summed here
        splits = _xpw_grid(XPW_WGRAD, dt, p, ci, co)
        out = torch.empty((splits, co, ci), dtype=torch.float32, device=dev)
        extra = (None, None)
    err = native.library().kdcc_xpw_wgrad(
        _DTYPE_CODE[dt], gy.data_ptr(),
        _ptr(a_next if pn is not None else None), _ptr(pn), a_k.data_ptr(),
        _ptr(bnk), out.data_ptr(), *extra, p, ci, co, _act_code(relu_k),
        float(eps), splits, _stream(gy))
    native.check(err, f"xpw_wgrad ({n},{h},{wd}) {ci}<-{co}")
    return out if dt == torch.bfloat16 else out.sum(0)


def dw_bwd_grid(dt, n, h, w, c, stride, dil):
    """The depthwise backward kernel's CTAs along x for a shape: the first
    dimension of its CTA partials (csrc/bn_passes.cu sizes it to the card:
    the CTAs it holds at once over the c / slice channel slices). It takes
    stride 1 at a dilation of DW_DILATIONS and stride 2 at dilation 1."""
    from .. import native

    grid = native.library().kdcc_dw_bwd_grid(_DTYPE_CODE[dt], n, h, w, c,
                                             stride, dil)
    if grid < 1:
        raise ValueError(f"dw_bwd takes no ({n},{h},{w},{c}) at stride "
                         f"{stride}, dilation {dil}")
    return grid


def _launch_dw_bwd(gy, a_next, a_k, pn, bnk, k, relu_k, eps, stride, dil):
    from .. import native

    _check_act(gy, "dw_bwd")
    n, h, w, c = a_k.shape
    dev, dt = gy.device, gy.dtype
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    if pn is None:
        raise ValueError("dw_bwd takes the next BN's backward pack")
    _need(gy, "gy", (n, ho, wo, c), dt, dev)
    _need(a_next, "a_next", (n, ho, wo, c), dt, dev)
    _need(a_k, "a_k", (n, h, w, c), dt, dev)
    _need(pn, "pn", (c, 6), torch.float32, dev)
    _need(bnk, "bnk", (c, 4), torch.float32, dev)
    _need(k, "k", (c, 9), torch.float32, dev)
    if c % 8:
        raise ValueError(f"dw_bwd: the kernel takes a width divisible by 8, "
                         f"got {c}")
    if any(t.data_ptr() % 16 for t in (gy, a_next, a_k)):
        raise ValueError("dw_bwd reads 8 channels per access: gy, a_next "
                         "and a_k must be 16-byte aligned")
    grid = dw_bwd_grid(dt, n, h, w, c, stride, dil)
    gyk = torch.empty_like(a_k)
    psum = torch.empty((grid, 2, c), dtype=torch.float32, device=dev)
    pk = torch.empty((grid, 9, c), dtype=torch.float32, device=dev)
    err = native.library().kdcc_dw_bwd(
        _DTYPE_CODE[dt], gy.data_ptr(), a_next.data_ptr(), pn.data_ptr(),
        a_k.data_ptr(), _ptr(bnk), k.data_ptr(), gyk.data_ptr(),
        psum.data_ptr(), pk.data_ptr(), n, h, w, c, stride, dil,
        _act_code(relu_k), float(eps), grid, _stream(gy))
    native.check(err, f"dw_bwd stride {stride} dilation {dil} "
                      f"({n},{h},{w},{c})")
    return gyk, psum.sum(0).t(), pk.sum(0).t()


def _check_f0_width(what, c0):
    if c0 % 8 or not 8 <= c0 <= F0_MAX_C:
        raise ValueError(f"{what}: the kernel takes C0 divisible by 8 up to "
                         f"{F0_MAX_C}, got {c0}")


def _w0_taps(w0, dt, c0, device):
    """(C0, 3, 3, 3) entry-conv weight, any memory format -> (C0, 27) in dt,
    taps (dh, dw, ci), contiguous."""
    if tuple(w0.shape) != (c0, 3, 3, 3) or w0.device != device:
        raise ValueError(f"w0 must be a ({c0}, 3, 3, 3) tensor on {device}, "
                         f"got {tuple(w0.shape)} on {w0.device}")
    return w0.to(dt).permute(0, 2, 3, 1).reshape(c0, 27).contiguous()


def _f0_grid(n, h, w, c0):
    tp = THREADS // (c0 // 8)
    return min(n * ((h + 1) // 2) * math.ceil((w + 1) // 2 / tp), F0_GRID)


def _launch_f0(x, w0):
    from .. import native

    _check_act(x, "f0")
    n, h, w, _ = x.shape
    c0 = w0.shape[0]
    if x.shape[-1] != 3:
        raise ValueError(f"f0 takes a 3-channel image, got {x.shape[-1]} "
                         f"channels")
    _check_f0_width("f0", c0)
    wt = _w0_taps(w0, x.dtype, c0, x.device)
    grid = _f0_grid(n, h, w, c0)
    y = torch.empty((n, (h + 1) // 2, (w + 1) // 2, c0), dtype=x.dtype,
                    device=x.device)
    part = torch.empty((grid, 2, c0), dtype=torch.float32, device=x.device)
    err = native.library().kdcc_f0_fwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), wt.data_ptr(), y.data_ptr(),
        part.data_ptr(), n, h, w, c0, grid, _stream(x))
    native.check(err, f"f0 ({n},{h},{w},3) -> {c0}")
    return y, part.sum(0)


def _check_f0_bwd(what, gy, a0, pn, x_shape):
    _check_act(gy, what)
    n, h, w, _ = x_shape
    c0 = gy.shape[-1]
    _check_f0_width(what, c0)
    _need(gy, "gy", (n, (h + 1) // 2, (w + 1) // 2, c0), gy.dtype, gy.device)
    _need(a0, "a0", gy.shape, gy.dtype, gy.device)
    _need(pn, "pn", (c0, 6), torch.float32, gy.device)
    if gy.data_ptr() % 16 or a0.data_ptr() % 16:
        raise ValueError(f"{what} reads 8 channels per access: gy and a0 "
                         f"must be 16-byte aligned")
    return n, h, w, c0


def _launch_f0_wgrad(gy, a0, x, pn, eps):
    from .. import native

    n, h, w, c0 = _check_f0_bwd("f0_wgrad", gy, a0, pn, x.shape)
    _need(x, "x", (n, h, w, 3), gy.dtype, gy.device)
    grid = _f0_grid(n, h, w, c0)
    part = torch.empty((grid, c0, 27), dtype=torch.float32, device=gy.device)
    err = native.library().kdcc_f0_wgrad(
        _DTYPE_CODE[gy.dtype], gy.data_ptr(), a0.data_ptr(), x.data_ptr(),
        pn.data_ptr(), part.data_ptr(), n, h, w, c0, float(eps), grid,
        _stream(gy))
    native.check(err, f"f0_wgrad ({n},{h},{w},3) -> {c0}")
    return part.sum(0).reshape(c0, 3, 3, 3).permute(0, 3, 1, 2).contiguous()


def _launch_f0_xgrad(gy, a0, pn, w0, x_shape, eps):
    from .. import native

    n, h, w, c0 = _check_f0_bwd("f0_xgrad", gy, a0, pn, x_shape)
    wt = _w0_taps(w0, gy.dtype, c0, gy.device)
    dx = torch.empty((n, h, w, 3), dtype=gy.dtype, device=gy.device)
    err = native.library().kdcc_f0_xgrad(
        _DTYPE_CODE[gy.dtype], gy.data_ptr(), a0.data_ptr(), pn.data_ptr(),
        wt.data_ptr(), dx.data_ptr(), n, h, w, c0, float(eps), _stream(gy))
    native.check(err, f"f0_xgrad ({n},{h},{w},3) <- {c0}")
    return dx


# ---------------------------------------------------------------------------
# the six passes (stem.py:618-717, 1049-1175) and the three entry-conv
# kernels (stem.py:441-566)
# ---------------------------------------------------------------------------

def _with_moments(y, sums):
    """(y, mean, var of y), or (y, None, None) where no moments were
    taken."""
    if sums is None:
        return y, None, None
    return (y, *_moments(sums, _count(y)))


def run_bn_pw(x, bn, w, relu, eps=EPS, moments=True):
    """BN (+act) -> 1x1 conv w (Co, Ci) -> (y, mean, var of y); the narrow
    kernel where `pw_narrow` holds, else `run_bn_pw_wide`. moments=False
    (an eval pass) takes no moments and returns (y, None, None)."""
    _check_args(relu)
    if x.device.type == "cpu":
        y, sums = bn_pw_ref(x, bn, w, relu, eps)
        return _with_moments(y, sums if moments else None)
    if not pw_narrow(x.shape[-1], w.shape[0]):
        return run_bn_pw_wide(x, bn, w, relu, eps, moments)
    out = _launch_bn_pw(x, bn, w, relu, eps, moments)
    run_bn_pw.launches += 1
    return out


def run_bn_pw_wide(x, bn, w, relu, eps=EPS, moments=True):
    """`run_bn_pw` on the wide kernel (csrc/wide_pw.cu), for CUDA tensors:
    `run_bn_pw` takes a CPU tensor to the plain version."""
    _check_args(relu)
    out = _launch_bn_pw_wide(x, bn, w, relu, eps, moments)
    run_bn_pw_wide.launches += 1
    return out


def run_bn_dw(x, bn, k, relu, eps=EPS, dil=1, moments=True):
    """BN (+act) -> 3x3 depthwise k (C, 9), stride 1, dilation and pad
    `dil`; moments as in `run_bn_pw`."""
    _check_args(relu, dil)
    if x.device.type == "cpu":
        y, sums = bn_dw_ref(x, bn, k, relu, eps, 1, dil)
        return _with_moments(y, sums if moments else None)
    out = _launch_bn_dw(x, bn, k, relu, eps, 1, dil, moments)
    run_bn_dw.launches += 1
    run_bn_dw.launches_by_dil[dil] += 1
    return out


def run_bn_dw_s2(x, bn, k, relu, eps=EPS, moments=True):
    """BN (+act) -> 3x3 depthwise, stride 2, pad 1: output (H + 1) // 2;
    moments as in `run_bn_pw`."""
    _check_args(relu)
    if x.device.type == "cpu":
        y, sums = bn_dw_ref(x, bn, k, relu, eps, 2)
        return _with_moments(y, sums if moments else None)
    out = _launch_bn_dw(x, bn, k, relu, eps, 2, 1, moments)
    run_bn_dw_s2.launches += 1
    return out


def run_pw_bwd(gy, a_next, a_k, pn, bnk, w, relu_k, eps=EPS):
    """Backward of [BN_k (+relu_k) -> 1x1 w -> a_next]: (gy_k, sums, dW);
    the narrow kernel where `pw_narrow` holds, else the two wide ones."""
    _check_args(relu_k)
    if gy.device.type == "cpu":
        return pw_bwd_ref(gy, a_next, a_k, pn, bnk, w, relu_k, eps)
    if not pw_narrow(a_k.shape[-1], gy.shape[-1]):
        return (*run_xpw_dgrad(gy, a_next, a_k, pn, bnk, w, relu_k, eps),
                run_xpw_wgrad(gy, a_next, a_k, pn, bnk, w, relu_k, eps))
    out = _launch_pw_bwd(gy, a_next, a_k, pn, bnk, w, relu_k, eps)
    run_pw_bwd.launches += 1
    return out


def run_xpw_dgrad(gy, a_next, a_k, pn, bnk, w, relu_k, eps=EPS):
    """The wide 1x1 backward's input side, (gy_k, sums (Ci, 2)), for CUDA
    tensors (`run_pw_bwd` takes a CPU tensor to the plain version)."""
    _check_args(relu_k)
    out = _launch_xpw_dgrad(gy, a_next, a_k, pn, bnk, w, relu_k, eps)
    run_xpw_dgrad.launches += 1
    return out


def run_xpw_wgrad(gy, a_next, a_k, pn, bnk, w, relu_k, eps=EPS):
    """The wide 1x1 backward's weight side, dW (Co, Ci) f32, for CUDA
    tensors."""
    _check_args(relu_k)
    out = _launch_xpw_wgrad(gy, a_next, a_k, pn, bnk, w, relu_k, eps)
    run_xpw_wgrad.launches += 1
    return out


def run_dw_bwd(gy, a_next, a_k, pn, bnk, k, relu_k=True, eps=EPS, dil=1):
    """Backward of [BN_k (+relu_k) -> 3x3 depthwise s1, dilation `dil` ->
    a_next]: (gy_k, sums, dk)."""
    _check_args(relu_k, dil)
    if gy.device.type == "cpu":
        return dw_bwd_ref(gy, a_next, a_k, pn, bnk, k, relu_k, eps, 1, dil)
    out = _launch_dw_bwd(gy, a_next, a_k, pn, bnk, k, relu_k, eps, 1, dil)
    run_dw_bwd.launches += 1
    run_dw_bwd.launches_by_dil[dil] += 1
    return out


def run_dw_s2_bwd(gy, a_next, a_k, pn, bnk, k, relu_k=True, eps=EPS):
    """Backward of [BN_k (+relu_k) -> 3x3 depthwise s2 -> a_next]."""
    _check_args(relu_k)
    if gy.device.type == "cpu":
        return dw_bwd_ref(gy, a_next, a_k, pn, bnk, k, relu_k, eps, 2)
    out = _launch_dw_bwd(gy, a_next, a_k, pn, bnk, k, relu_k, eps, 2, 1)
    run_dw_s2_bwd.launches += 1
    return out


def run_f0(x, w0):
    """Entry conv x (N, H, W, 3) * w0 (C0, 3, 3, 3), stride 2, pad 1 ->
    (a0, mean, var), the moments from the f32 values before rounding."""
    if x.device.type == "cpu":
        y, sums = f0_ref(x, w0)
    else:
        y, sums = _launch_f0(x, w0)
        run_f0.launches += 1
    return (y, *_moments(sums, _count(y)))


def run_f0_wgrad(gy, a0, x, pn, eps=EPS):
    """dW0 (C0, 3, 3, 3) f32 from bn0's backward of gy (pack pn (C0, 6))."""
    if gy.device.type == "cpu":
        return f0_wgrad_ref(gy, a0, x, pn, eps)
    out = _launch_f0_wgrad(gy, a0, x, pn, eps)
    run_f0_wgrad.launches += 1
    return out


def run_f0_xgrad(gy, a0, pn, w0, x_shape, eps=EPS):
    """The image gradient (N, H, W, 3) = x_shape, in gy's dtype."""
    if gy.device.type == "cpu":
        return f0_xgrad_ref(gy, a0, pn, w0, x_shape, eps)
    out = _launch_f0_xgrad(gy, a0, pn, w0, tuple(x_shape), eps)
    run_f0_xgrad.launches += 1
    return out


PASSES = (run_bn_pw, run_bn_dw, run_bn_dw_s2, run_pw_bwd, run_dw_bwd,
          run_dw_s2_bwd)
WIDE_PASSES = (run_bn_pw_wide, run_xpw_dgrad, run_xpw_wgrad)
F0_KERNELS = (run_f0, run_f0_wgrad, run_f0_xgrad)
for _fn in PASSES + WIDE_PASSES + F0_KERNELS:
    _fn.launches = 0
for _fn in (run_bn_dw, run_dw_bwd):
    _fn.launches_by_dil = dict.fromkeys(DW_DILATIONS, 0)


# ---------------------------------------------------------------------------
# the stem chain (stem.py:1182-1415)
# ---------------------------------------------------------------------------

STEM_KEYS = ("k1", "w1", "w2", "k2", "w3",
             *(f"{g}{i}" for i in range(6) for g in "gb"))
STEM_KEYS_F0 = ("w0", *STEM_KEYS)


def _stem_fwd(inp, p, eps):
    """inp: the image (N, H, W, 3) with "w0" in p, else a0 (N, H', W', C0),
    the pre-BN entry-conv output. Returns (f2 output NHWC, six (mean, var),
    the residual activations)."""
    dt, pdt = inp.dtype, _pdt(inp.dtype)
    if "w0" in p:
        a0, m0, v0 = run_f0(inp, p["w0"])
    else:
        # bn0's moments in torch, as sum and sum of squares (one reduction
        # each, accumulated in the stats dtype, with no widened copy of a0)
        a0 = inp
        cnt0 = float(_count(a0))
        m0 = a0.sum((0, 1, 2), dtype=pdt) / cnt0
        v0 = (torch.linalg.vector_norm(a0, 2, (0, 1, 2), dtype=pdt).square()
              / cnt0 - m0 * m0)

    def bn(i, m, v):
        return _bn_pack(m, v, p[f"g{i}"], p[f"b{i}"])

    def pw(key):
        return p[key].to(dt).contiguous()

    def dw(key):
        return p[key].to(pdt).contiguous()

    a1, m1, v1 = run_bn_dw(a0, bn(0, m0, v0), dw("k1"), True, eps)
    a2, m2, v2 = run_bn_pw(a1, bn(1, m1, v1), pw("w1"), True, eps)
    a3, m3, v3 = run_bn_pw(a2, bn(2, m2, v2), pw("w2"), False, eps)
    a4, m4, v4 = run_bn_dw_s2(a3, bn(3, m3, v3), dw("k2"), True, eps)
    a5, m5, v5 = run_bn_pw(a4, bn(4, m4, v4), pw("w3"), True, eps)
    out = _affine(a5, m5, v5, p["g5"], p["b5"], eps).to(dt)
    stats = ((m0, v0), (m1, v1), (m2, v2), (m3, v3), (m4, v4), (m5, v5))
    return out, stats, (a0, a1, a2, a3, a4, a5)


def _stem_bwd(p, stats, acts, g_out, eps, inp=None, need_input_grad=True):
    """Backward of _stem_fwd from the f2-output cotangent: (d input or None,
    grads). inp: the image in f0 mode (its gradient only if
    need_input_grad)."""
    a0, a1, a2, a3, a4, a5 = acts
    dt, pdt = a0.dtype, _pdt(a0.dtype)
    (m0, v0), (m1, v1), (m2, v2), (m3, v3), (m4, v4), (m5, v5) = stats
    big, small = float(_count(a0)), float(_count(a5))

    def bn(i, m, v):
        return _bn_pack(m, v, p[f"g{i}"], p[f"b{i}"])

    def pack(i, m, v, s, count):
        return _bnbwd_pack(m, v, p[f"g{i}"], s[:, 0], s[:, 1], count)

    def pw(key):
        return p[key].to(dt).contiguous()

    def dw(key):
        return p[key].to(pdt).contiguous()

    # bn5 backward in torch
    ga5, sg5, sgx5 = _bn_train_bwd(g_out.contiguous(), a5, m5, v5, p["g5"],
                                   eps)
    ga5 = ga5.to(dt)
    gy4, s4, dw3 = run_pw_bwd(ga5, None, a4, None, bn(4, m4, v4), pw("w3"),
                              True, eps)
    gy3, s3, dk2 = run_dw_s2_bwd(gy4, a4, a3, pack(4, m4, v4, s4, small),
                                 bn(3, m3, v3), dw("k2"), True, eps)
    gy2, s2, dw2 = run_pw_bwd(gy3, a3, a2, pack(3, m3, v3, s3, big),
                              bn(2, m2, v2), pw("w2"), False, eps)
    gy1, s1, dw1 = run_pw_bwd(gy2, a2, a1, pack(2, m2, v2, s2, big),
                              bn(1, m1, v1), pw("w1"), True, eps)
    gy0, s0, dk1 = run_dw_bwd(gy1, a1, a0, pack(1, m1, v1, s1, big),
                              bn(0, m0, v0), dw("k1"), True, eps)
    grads = {"k1": dk1, "k2": dk2, "w1": dw1, "w2": dw2, "w3": dw3,
             "g5": sgx5, "b5": sg5}
    if "w0" in p:
        # bn0's backward inside the entry-conv kernels: ga0 is never stored
        pn0 = pack(0, m0, v0, s0, big)
        grads["w0"] = run_f0_wgrad(gy0, a0, inp, pn0, eps)
        dinp = (run_f0_xgrad(gy0, a0, pn0, p["w0"], inp.shape, eps)
                if need_input_grad else None)
    else:
        # bn0 backward in torch, with the sums the dw1 link returned
        dinp = _bn_bwd_affine(gy0, a0 - m0, torch.rsqrt(v0 + eps), p["g0"],
                              s0[:, 0], s0[:, 1], big).to(dt)
    for i, s in enumerate((s0, s1, s2, s3, s4)):
        grads[f"g{i}"], grads[f"b{i}"] = s[:, 1], s[:, 0]
    return dinp, {k: v.to(p[k].dtype) for k, v in grads.items()}


class _FusedStem(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inp, eps, keys, *flat):
        p = dict(zip(keys, flat))
        out, stats, acts = _stem_fwd(inp, p, eps)
        ctx.eps, ctx.keys, ctx.stats, ctx.acts = eps, keys, stats, acts
        ctx.save_for_backward(inp if "w0" in p else None, *flat)
        flat_stats = [t for mv in stats for t in mv]
        ctx.mark_non_differentiable(*flat_stats)
        return (out, *flat_stats)

    @staticmethod
    def backward(ctx, g_out, *_):
        inp, *flat = ctx.saved_tensors
        p = dict(zip(ctx.keys, flat))
        dinp, dp = _stem_bwd(p, ctx.stats, ctx.acts, g_out, ctx.eps, inp,
                             ctx.needs_input_grad[0])
        return (dinp, None, None, *(dp[k] for k in ctx.keys))


def fused_stem_f1f2(a0, params, eps: float = EPS):
    """MobileNetV2 features[1..2] (IR t=1 + IR t=6 s2), training mode; with
    "w0" in params, features[0] (the entry conv and its BN) too.

    a0: the entry conv's output before its BN, NHWC (N, H, W, C0); in f0
    mode the image, NHWC (N, H, W, 3), in the compute dtype, and w0
    (C0, 3, 3, 3) the entry conv's weight (3x3 / stride 2 / pad 1). params:
    k1 (C0, 9) and k2 (C2, 9) depthwise kernels [dh * 3 + dw]; w1, w2, w3
    1x1 weights (Co, Ci); g0..g5 / b0..b5 the six BN affine pairs (bn0 =
    the entry conv's BN .. bn5 = f2.pw_bn). w0 and the 1x1 weights are cast
    to the input's dtype; everything else computes in f32. Returns (f2
    output NHWC in the input's dtype, at half the resolution of a0, six
    (mean, var) batch moments). Gradients reach the input and every
    parameter."""
    keys = STEM_KEYS_F0 if "w0" in params else STEM_KEYS
    outs = _FusedStem.apply(a0.contiguous(), float(eps), keys,
                            *(params[k] for k in keys))
    return outs[0], tuple(zip(outs[1::2], outs[2::2]))
