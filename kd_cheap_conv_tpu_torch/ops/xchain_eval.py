"""Fused Xception-65 chains, eval mode: the middle flow, the exit flow
("tail") and the entry blocks with running-statistic BNs.

Counterpart of the eval half of kd_cheap_conv_tpu/ops/pallas/xchain.py
(`fused_x_middle_eval`, `fused_x_tail_eval`, `fused_x_entry_block_eval`,
`_fold_block_eval`, `_fold_sep_eval`), kept apart from the train half
(ops/xchain.py) as ops/irchain_eval.py is from ops/irchain.py. Tensors are
NHWC-contiguous; none of the TPU's (1, R, C, N*W) fold, row blocks or their
switches is carried over. Forward only: the config-#3 teacher and Xception
serving run under no_grad.

Every BN of a separable conv of the middle and exit flow folds into its 1x1
conv (`fold_sep_eval`, the JAX `_fold_sep_eval`), with s = gamma *
rsqrt(var + eps) and t = beta - mean * s of the depthwise BN (D) and of the
BN after the 1x1 (P):

    W'' = sP * W * sD            (Co, Ci), rounded to the activation dtype
    b'' = sP * (W @ tD) + tP     (Co,) f32; the depthwise taps stay f32

so one sep conv (`run_xsep_eval`) is, in bfloat16, two launches of
csrc/xchain_eval.cu, the depthwise pass `xsep_dw_kernel` (`run_xsep_dw`)
and the TMA + wgmma product `xsep_mm_kernel` (`run_xsep_mm`):

    t = round(dw3x3(act(x), k, dilation d))   f32 sums, zero outside each image
    y = b'' + W'' . t  [+ x0 | + bsk + Wsk'' . x0]  [relu]

and in float32 (parity checks) one launch of `xsep_eval_kernel`. A middle
block is three sep convs, the residual added by the third; the exit block
three, the third with its 1x1 skip (Wsk'' = sSK * Wsk, bias tSK); the
three exit seps three more, the last with the final relu: 48 + 6 sep convs
for the 16-block Xception-65. The JAX kernels hold a whole block in VMEM;
here the block's two intermediates go through device memory, kept in f32
as the JAX kernels keep them (`_k_block_eval` casts only the block's
output), so the rounding points are the JAX kernels': t and W'' rounded to
the activation dtype before the product (`_mm`), f32 sums, the block's
output rounded once, the residual its dt input widened to f32.

The entry blocks (`fused_x_entry_block_eval`) run the pass wrappers of
ops/stem.py with running-statistic packs, as JAX runs its stem passes
there: sep1 and sep2 on `run_bn_dw`, sep3 on `run_bn_dw_s2`, each 1x1 on
`run_bn_pw` (the wide kernel at these widths) with its depthwise BN's pack,
all with moments=False: the kernels take no batch moments (JAX computes
and drops them). sep3's BN is a torch affine on the
running statistics, and the 1x1 / stride-2 skip runs on its modules
(`skip_bn(skip_conv(x))`), as in the JAX function.

The folds are cached on the modules (ops/foldcache.py): a teacher folds
once, a student's validation again after each optimizer step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .foldcache import cached_fold
from .rchain import _bn_fold
from .stem import (_DTYPE_CODE, _affine, _bn_pack, _check_act, _need, _pdt,
                   _stream, run_bn_dw, run_bn_dw_s2, run_bn_pw)

TAPS = 9


class FoldedSep(NamedTuple):
    taps: torch.Tensor            # (9, Ci) f32, [dh * 3 + dw][c]
    w: torch.Tensor               # (Co, Ci) activation dtype
    b: torch.Tensor               # (Co,) f32


class FoldedSkip(NamedTuple):
    w: torch.Tensor               # (Co, C0) activation dtype
    b: torch.Tensor               # (Co,) f32


def _fold_inputs(s):
    """The tensors a SepConvBN's fold reads."""
    bd, bp = s.sep.bn_dw, s.bn
    return [s.sep.depthwise.weight, s.sep.pointwise.weight,
            *(t for bn in (bd, bp) for t in (bn.weight, bn.bias,
                                               bn.running_mean,
                                               bn.running_var))]


def fold_sep_eval(s, dtype) -> FoldedSep:
    """One SepConvBN's eval BNs folded into its 1x1 conv (JAX
    `_fold_sep_eval`), computed in f32 (f64 for f64): W'' rounded to
    `dtype`, the taps and b'' in f32."""
    def build():
        cdt = _pdt(dtype)
        dw, pw = s.sep.depthwise, s.sep.pointwise
        c = dw.weight.shape[0]
        taps = dw.weight.to(cdt).reshape(c, TAPS).t().contiguous()
        w = pw.weight.to(cdt)[:, :, 0, 0]
        sd, td = _bn_fold(s.sep.bn_dw, cdt)
        sp, tp = _bn_fold(s.bn, cdt)
        wf = (sp[:, None] * w * sd[None, :]).to(dtype).contiguous()
        return FoldedSep(taps, wf, (sp * (w @ td) + tp).contiguous())

    return cached_fold(s, "_kdcc_eval_fold", _fold_inputs(s), dtype, build)


def fold_block_eval(blk, dtype) -> tuple[FoldedSep, FoldedSep, FoldedSep]:
    """The three folded sep convs of an Xception block (JAX
    `_fold_block_eval`)."""
    return tuple(fold_sep_eval(s, dtype)
                 for s in (blk.sep1, blk.sep2, blk.sep3))


def fold_skip_eval(blk, dtype) -> FoldedSkip:
    """A block's 1x1 skip and its eval BN: (sSK * Wsk in `dtype`, tSK f32)
    (xchain.py:849-853)."""
    bn = blk.skip_bn

    def build():
        cdt = _pdt(dtype)
        s, t = _bn_fold(bn, cdt)
        w = blk.skip_conv.weight.to(cdt)[:, :, 0, 0]
        return FoldedSkip((s[:, None] * w).to(dtype).contiguous(), t)

    return cached_fold(blk, "_kdcc_eval_skip_fold",
                       [blk.skip_conv.weight, bn.weight, bn.bias,
                        bn.running_mean, bn.running_var], dtype, build)


# ---------------------------------------------------------------------------
# the kernels: one folded separable conv
# ---------------------------------------------------------------------------

def xsep_eval_ref(x, taps, w, b, *, dil=1, pre_relu=True, final_relu=False,
                  x0=None, wsk=None, bsk=None, out_dtype=None):
    """Plain version of the folded sep conv: act(x) and the depthwise sums
    in f32 (f64 for f64), t rounded to w's dtype, the products in f32 of
    operands in that dtype, the bias, residual or skip and relu added in
    f32, y rounded once to out_dtype (default w's dtype). On the card the
    depthwise conv must run without TF32 (torch.backends.cudnn.allow_tf32 =
    False) and the products with torch.backends.cuda.matmul.allow_tf32 =
    False to sum what the kernels sum."""
    dt = w.dtype
    cdt = _pdt(dt)
    c = x.shape[-1]
    h = x.to(cdt)
    if pre_relu:
        h = h.clamp_min(0.0)
    t = F.conv2d(h.permute(0, 3, 1, 2), taps.to(cdt).t().reshape(c, 1, 3, 3),
                 None, 1, dil, dil, c).permute(0, 2, 3, 1)
    y = t.to(dt).to(cdt) @ w.to(cdt).t() + b.to(cdt)
    if x0 is not None and wsk is None:
        y = y + x0.to(cdt)
    elif x0 is not None:
        y = y + (x0.to(cdt) @ wsk.to(cdt).t() + bsk.to(cdt))
    if final_relu:
        y = y.clamp_min(0.0)
    return y.to(out_dtype or dt).contiguous()


def xsep_dw_ref(x, taps, *, dil=1, pre_relu=True, dtype=torch.bfloat16):
    """Plain version of the depthwise pass: t = dw3x3(act(x), taps,
    dilation dil) in f32 (zero outside each image), rounded to `dtype` (the
    kernel's: bfloat16). x (N, H, W, C) in bfloat16 or f32, taps (9, C)
    f32."""
    c = x.shape[-1]
    h = x.float()
    if pre_relu:
        h = h.clamp_min(0.0)
    k = taps.float().t().reshape(c, 1, 3, 3)
    t = F.conv2d(h.permute(0, 3, 1, 2), k, None, 1, dil, dil, c)
    return t.permute(0, 2, 3, 1).to(dtype).contiguous()


def xsep_mm_ref(t, w, b, *, final_relu=False, x0=None, wsk=None, bsk=None,
                out_dtype=torch.bfloat16):
    """Plain version of the product: y = b + t . W^T (f32 sums of t's and
    w's values) [+ x0 | + bsk + x0 . Wsk^T] [relu], rounded once to
    out_dtype. The kernel's operands are bfloat16: t (N, H, W, Ci), w (Co,
    Ci), x0, wsk; b, bsk f32."""
    y = t.float() @ w.float().t() + b.float()
    if x0 is not None and wsk is None:
        y = y + x0.float()
    elif x0 is not None:
        y = y + (x0.float() @ wsk.float().t() + bsk.float())
    if final_relu:
        y = y.clamp_min(0.0)
    return y.to(out_dtype).contiguous()


def _aligned(t, what):
    if t is not None and t.data_ptr() % 16:
        raise ValueError(f"xsep_eval reads 8 channels per access: {what} "
                         f"must be 16-byte aligned")


def _check_sep(x, taps, w, b, dil, x0, wsk, bsk, out_dtype):
    """A folded sep conv's arguments on the card (both the bfloat16 path's
    kernels' and the float32 kernel's)."""
    _check_act(x, "xsep_eval")
    n, h, wd, ci = x.shape
    co, dt, dev = w.shape[0], w.dtype, x.device
    if dt not in _DTYPE_CODE or x.dtype not in (dt, torch.float32) \
            or out_dtype not in (dt, torch.float32):
        raise TypeError(f"xsep_eval takes weights in float32 or bfloat16, "
                        f"the input and output in their dtype or float32, "
                        f"got {x.dtype} -> {w.dtype} -> {out_dtype}")
    _need(taps, "taps", (TAPS, ci), torch.float32, dev)
    _need(w, "w", (co, ci), dt, dev)
    _need(b, "b", (co,), torch.float32, dev)
    c0 = 0
    if x0 is not None:
        c0 = co if wsk is None else wsk.shape[1]
        _need(x0, "x0", (n, h, wd, c0), dt, dev)
        _need(wsk, "wsk", (co, c0), dt, dev)
        _need(bsk, "bsk", (co,), torch.float32, dev)
        if (wsk is None) != (bsk is None):
            raise ValueError("xsep_eval: the skip takes both wsk and bsk")
    if any(c % 8 or c < 8 for c in (ci, co, c0 or 8)) or dil < 1:
        raise ValueError(f"xsep_eval takes widths divisible by 8 and a "
                         f"dilation >= 1, got {ci} -> {co} (skip {c0}), "
                         f"dilation {dil}")
    if n * h * wd * max(ci, co, c0) >= 2 ** 31:
        raise ValueError("xsep_eval: the output exceeds the kernel's 32-bit "
                         "pixel index")
    for t, what in ((x, "x"), (taps, "taps"), (w, "w"), (x0, "x0"),
                    (wsk, "wsk")):
        _aligned(t, what)


def _launch_f32(x, taps, w, b, dil, pre_relu, final_relu, x0, wsk, bsk):
    from .. import native

    n, h, wd, ci = x.shape
    co = w.shape[0]
    y = torch.empty((n, h, wd, co), dtype=torch.float32, device=x.device)
    residual = 0 if x0 is None else 1 if wsk is None else 2
    c0 = 0 if x0 is None else x0.shape[-1]
    err = native.library().kdcc_xsep_eval(
        x.data_ptr(), taps.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if x0 is None else x0.data_ptr(),
        None if wsk is None else wsk.data_ptr(),
        None if bsk is None else bsk.data_ptr(), y.data_ptr(), n, h, wd, ci,
        co, c0, int(dil), int(bool(pre_relu)), residual,
        int(bool(final_relu)), _stream(x))
    native.check(err, f"xsep_eval ({n},{h},{wd},{ci}) -> {co}, dilation "
                      f"{dil}, residual {residual}")
    return y


def _launch_dw(x, taps, dil, pre_relu):
    from .. import native

    n, h, wd, ci = x.shape
    t = torch.empty((n, h, wd, ci), dtype=torch.bfloat16, device=x.device)
    err = native.library().kdcc_xsep_dw(
        _DTYPE_CODE[x.dtype], x.data_ptr(), taps.data_ptr(), t.data_ptr(), n,
        h, wd, ci, int(dil), int(bool(pre_relu)), _stream(x))
    native.check(err, f"xsep_dw ({n},{h},{wd},{ci}), dilation {dil}")
    run_xsep_dw.launches += 1
    return t


def _launch_mm(t, w, b, final_relu, x0, wsk, bsk, out_dtype):
    from .. import native

    n, h, wd, ci = t.shape
    co = w.shape[0]
    y = torch.empty((n, h, wd, co), dtype=out_dtype, device=t.device)
    residual = 0 if x0 is None else 1 if wsk is None else 2
    err = native.library().kdcc_xsep_mm(
        _DTYPE_CODE[out_dtype], t.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if x0 is None else x0.data_ptr(),
        None if wsk is None else wsk.data_ptr(),
        None if bsk is None else bsk.data_ptr(), y.data_ptr(), n * h * wd, ci,
        co, 0 if x0 is None else x0.shape[-1], residual,
        int(bool(final_relu)), _stream(t))
    native.check(err, f"xsep_mm ({n},{h},{wd},{ci}) -> {co}, residual "
                      f"{residual}")
    run_xsep_mm.launches += 1
    return y


def run_xsep_dw(x, taps, *, dil=1, pre_relu=True):
    """The bfloat16 sep conv's depthwise pass, csrc/xchain_eval.cu
    `xsep_dw_kernel`: t (N, H, W, C) bfloat16 from x (N, H, W, C) in
    bfloat16 or f32 and taps (9, C) f32. The kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return xsep_dw_ref(x, taps, dil=dil, pre_relu=pre_relu)
    _check_act(x, "xsep_dw")
    ci = x.shape[-1]
    _need(taps, "taps", (TAPS, ci), torch.float32, x.device)
    if ci % 8 or ci < 8 or dil < 1:
        raise ValueError(f"xsep_dw takes a width divisible by 8 and a "
                         f"dilation >= 1, got {ci}, dilation {dil}")
    _aligned(x, "x")
    return _launch_dw(x, taps, dil, pre_relu)


def run_xsep_mm(t, w, b, *, final_relu=False, x0=None, wsk=None, bsk=None,
                out_dtype=torch.bfloat16):
    """The bfloat16 sep conv's product, csrc/xchain_eval.cu
    `xsep_mm_kernel` (TMA + wgmma): y (N, H, W, Co) in out_dtype (bfloat16
    or f32) = b + t . W^T [+ x0 | + bsk + x0 . Wsk^T] [relu], t (N, H, W,
    Ci) and w (Co, Ci) bfloat16, b (Co,) f32. The kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if t.device.type == "cpu":
        return xsep_mm_ref(t, w, b, final_relu=final_relu, x0=x0, wsk=wsk,
                           bsk=bsk, out_dtype=out_dtype)
    _check_act(t, "xsep_mm")
    if t.dtype != torch.bfloat16 or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"xsep_mm takes a bfloat16 t and a float32 or "
                        f"bfloat16 output, got {t.dtype} -> {out_dtype}")
    n, h, wd, ci = t.shape
    co, dev, bf = w.shape[0], t.device, torch.bfloat16
    _need(w, "w", (co, ci), bf, dev)
    _need(b, "b", (co,), torch.float32, dev)
    c0 = 0
    if x0 is not None:
        c0 = co if wsk is None else wsk.shape[1]
        _need(x0, "x0", (n, h, wd, c0), bf, dev)
        _need(wsk, "wsk", (co, c0), bf, dev)
        _need(bsk, "bsk", (co,), torch.float32, dev)
    if any(c % 8 or c < 8 for c in (ci, co, c0 or 8)):
        raise ValueError(f"xsep_mm takes widths divisible by 8, got {ci} -> "
                         f"{co} (skip {c0})")
    for v, what in ((t, "t"), (w, "w"), (x0, "x0"), (wsk, "wsk")):
        _aligned(v, what)
    return _launch_mm(t, w, b, final_relu, x0, wsk, bsk, out_dtype)


def run_xsep_eval(x, taps, w, b, *, dil=1, pre_relu=True, final_relu=False,
                  x0=None, wsk=None, bsk=None, out_dtype=None):
    """One folded separable conv, NHWC in and out: x (N, H, W, Ci) in w's
    dtype or f32, taps (9, Ci) f32, w (Co, Ci), b (Co,) f32; x0 (N, H, W,
    Co) in w's dtype the identity residual, or with wsk (Co, C0) and bsk
    (Co,) the input of a 1x1 skip; y in out_dtype (default w's dtype). On a
    CUDA tensor, bfloat16 weights run the depthwise pass and the product
    (each counted on its wrapper, `run_xsep_dw` / `run_xsep_mm`), float32
    ones `xsep_eval_kernel` (counted here); on a CPU tensor the plain
    version."""
    out_dtype = out_dtype or w.dtype
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, taps, w, b, x0, wsk, bsk)):
        raise RuntimeError("xsep_eval is forward-only: call it under "
                           "torch.no_grad() or inference_mode()")
    if x.device.type == "cpu":
        return xsep_eval_ref(x, taps, w, b, dil=dil, pre_relu=pre_relu,
                             final_relu=final_relu, x0=x0, wsk=wsk, bsk=bsk,
                             out_dtype=out_dtype)
    _check_sep(x, taps, w, b, dil, x0, wsk, bsk, out_dtype)
    if w.dtype == torch.bfloat16:
        t = _launch_dw(x, taps, dil, pre_relu)
        return _launch_mm(t, w, b, final_relu, x0, wsk, bsk, out_dtype)
    y = _launch_f32(x, taps, w, b, dil, pre_relu, final_relu, x0, wsk, bsk)
    run_xsep_eval.launches += 1
    return y


run_xsep_eval.launches = 0
run_xsep_dw.launches = 0
run_xsep_mm.launches = 0


# ---------------------------------------------------------------------------
# the chains (xchain.py:152-190, :840-866, :1122-1168)
# ---------------------------------------------------------------------------

def _segment(x, folds, acts, dil, skip=None, residual=False,
             final_relu=False):
    """Three folded sep convs from x: the intermediates in f32 (the JAX
    kernels keep h in f32 between the convs of a block; f64 for f64), the
    last conv's output in x's dtype with the residual x or the skip on x."""
    dt, mid = x.dtype, _pdt(x.dtype)
    h = x
    for i, (f, act) in enumerate(zip(folds, acts)):
        last = i == len(folds) - 1
        extra = {}
        if last and residual:
            extra = {"x0": x}
        elif last and skip is not None:
            extra = {"x0": x, "wsk": skip.w, "bsk": skip.b}
        h = run_xsep_eval(h, *f, dil=dil, pre_relu=act,
                          final_relu=last and final_relu,
                          out_dtype=dt if last else mid, **extra)
    return h


def fused_x_middle_eval(x_nhwc, blocks, dil: int = 1):
    """The middle flow in eval mode (running-statistic BNs): per block
    (relu -> dw3x3(dil) -> 1x1 + b'') x 3 + residual, three launches. x_nhwc
    (N, H, W, C) the block3 output; returns NHWC in its dtype."""
    x = x_nhwc.contiguous()
    for blk in blocks:
        x = _segment(x, fold_block_eval(blk, x.dtype), (True,) * 3, dil,
                     residual=True)
    return x


def fused_x_tail_eval(x_nhwc, exit_block, exit_seps, dil: int = 2):
    """The exit flow in eval mode: the exit block (relu before each sep,
    the 1x1 skip on its input added by the third) and the three exit seps
    (relu after each: no activation into the first, the final relu after
    the last), six launches."""
    x = x_nhwc.contiguous()
    dt = x.dtype
    xb = _segment(x, fold_block_eval(exit_block, dt), (True,) * 3, dil,
                  skip=fold_skip_eval(exit_block, dt))
    return _segment(xb, tuple(fold_sep_eval(s, dt) for s in exit_seps),
                    (False, True, True), dil, final_relu=True)


def entry_eval_params(blk, dtype) -> tuple:
    """An entry block's pass operands, per sep (k (C, 9), w (Co, Ci) in
    `dtype`, the depthwise BN's and the sep's BN's running-statistic packs
    (C, 4)), cached as the folds are."""
    seps = (blk.sep1, blk.sep2, blk.sep3)

    def pack(bn):
        return _bn_pack(bn.running_mean, bn.running_var, bn.weight, bn.bias)

    def build():
        out = []
        for s in seps:
            dw, pw = s.sep.depthwise, s.sep.pointwise
            # views of the f32 weights where no cast is needed (detached)
            k = dw.weight.detach().to(_pdt(dtype))
            out.append((k.reshape(k.shape[0], TAPS).contiguous(),
                        pw.weight.detach()[:, :, 0, 0].to(dtype).contiguous(),
                        pack(s.sep.bn_dw), pack(s.bn)))
        return tuple(out)

    return cached_fold(blk, "_kdcc_eval_entry",
                       [t for s in seps for t in _fold_inputs(s)], dtype,
                       build)


def fused_x_entry_block_eval(x_nhwc, blk):
    """One entry block in eval mode (JAX `fused_x_entry_block_eval`): sep1
    and sep2 (stride 1), sep3 (stride 2) as depthwise + 1x1 pass pairs with
    running-statistic packs, sep3's BN on its running statistics, plus the
    1x1 / stride-2 skip on its modules. Returns NHWC at (H + 1) // 2."""
    x = x_nhwc.contiguous()
    dt = x.dtype
    eps = float(blk.sep1.sep.bn_dw.eps)
    a, bn = x, None
    act = "relu" if blk.sep1.pre_relu else False
    for i, (k, w, pd, pp) in enumerate(entry_eval_params(blk, dt)):
        if i < 2:
            aD, _, _ = run_bn_dw(a, bn, k, act, eps, moments=False)
        else:
            aD, _, _ = run_bn_dw_s2(a, bn, k, act, eps, moments=False)
        a, _, _ = run_bn_pw(aD, pd, w, False, eps, moments=False)
        bn, act = pp, "relu"
    bn3 = blk.sep3.bn
    main = _affine(a, bn3.running_mean, bn3.running_var, bn3.weight,
                   bn3.bias, eps).to(dt)
    sk = blk.skip_bn(blk.skip_conv(x.permute(0, 3, 1, 2)))
    return main + sk.permute(0, 2, 3, 1).to(dt)
