"""Fused MobileNetV2 inverted-residual chain features[3..6], training mode.

Counterpart of the train half of kd_cheap_conv_tpu/ops/pallas/irchain.py
(`fused_ir_chain`). The TPU's batch-folded (1, R, C, N*W) layout is not
carried over: tensors stay NHWC, the batch a dimension of its own. The
chain is built from the passes of ops/stem.py (csrc/bn_passes.cu). Per
block (expand 1x1 -> BN + relu6 -> 3x3 depthwise, stride 1 or 2 -> BN +
relu6 -> project 1x1 -> BN [+ residual]):

    aE = pw(x_b, identity BN, We)         # x_b is a finished tensor
    aD = dw(aE, bnE + relu6, k)           # s1 or s2
    aP = pw(aD, bnD + relu6, Wp)
    x_{b+1} = bnP(aP) [+ x_b]             # torch elementwise 'finish'

The backward mirrors the links in reverse, with the residual gradient added
between blocks and the low_level cotangent joining at the f3/f4 boundary.
"""

from __future__ import annotations

import torch

from .stem import (EPS, _affine, _bn_pack, _bn_train_bwd, _bnbwd_pack,
                   _count, _pdt, run_bn_dw, run_bn_dw_s2, run_bn_pw,
                   run_dw_bwd, run_dw_s2_bwd, run_pw_bwd)

# block spec: (stride, Cin, Ce, Cout, residual), features[3..6]
_BLOCKS = ((1, 24, 144, 24, True),     # f3
           (2, 24, 144, 32, False),    # f4
           (1, 32, 192, 32, True),     # f5
           (1, 32, 192, 32, True))     # f6

IR_KEYS = tuple(f"{k}{i}" for i in range(len(_BLOCKS))
                for k in ("we", "k", "wp", "ge", "be", "gd", "bd", "gp", "bp"))


def _ir_fwd(x0, p, eps):
    """x0 (N, H, W, 24) finished f2 output. Returns (f6 output, low_level
    (f3 output), per block ((mE, vE), (mD, vD), (mP, vP)), per block
    (x_in, aE, aD, aP))."""
    dt, pdt = x0.dtype, _pdt(x0.dtype)
    x, low = x0, None
    stats, acts = [], []
    for i, (stride, *_, res) in enumerate(_BLOCKS):
        aE, mE, vE = run_bn_pw(x, None, p[f"we{i}"].to(dt).contiguous(),
                               False, eps)
        bnE = _bn_pack(mE, vE, p[f"ge{i}"], p[f"be{i}"])
        k = p[f"k{i}"].to(pdt).contiguous()
        dw = run_bn_dw if stride == 1 else run_bn_dw_s2
        aD, mD, vD = dw(aE, bnE, k, True, eps)
        bnD = _bn_pack(mD, vD, p[f"gd{i}"], p[f"bd{i}"])
        aP, mP, vP = run_bn_pw(aD, bnD, p[f"wp{i}"].to(dt).contiguous(),
                               True, eps)
        xn = _affine(aP, mP, vP, p[f"gp{i}"], p[f"bp{i}"], eps)
        if res:
            xn = xn + x
        acts.append((x, aE, aD, aP))
        stats.append(((mE, vE), (mD, vD), (mP, vP)))
        x = xn.to(dt)
        if i == 0:
            low = x                               # the low_level tap
    return x, low, stats, acts


def _ir_bwd(p, stats, acts, g_out, g_low, eps):
    """Backward of _ir_fwd from the f6 and low_level cotangents."""
    dt, pdt = acts[0][0].dtype, _pdt(acts[0][0].dtype)
    grads = {}
    G = g_out.contiguous().to(dt)
    for i in reversed(range(len(_BLOCKS))):
        stride, *_, res = _BLOCKS[i]
        x_in, aE, aD, aP = acts[i]
        (mE, vE), (mD, vD), (mP, vP) = stats[i]
        m_out, m_in = float(_count(aP)), float(_count(aE))
        # finish backward: bnP's train-mode backward, in torch; g_blk is
        # the block output's cotangent, which the residual carries on
        g_blk = G
        gaP, sg, sgx = _bn_train_bwd(g_blk, aP, mP, vP, p[f"gp{i}"], eps)
        gaP = gaP.to(dt)
        grads[f"gp{i}"], grads[f"bp{i}"] = sgx, sg
        # project link (bnD relu6 -> pw): gaP arrives BN-backwarded
        bnD = _bn_pack(mD, vD, p[f"gd{i}"], p[f"bd{i}"])
        gyD, sD, grads[f"wp{i}"] = run_pw_bwd(
            gaP, None, aD, None, bnD, p[f"wp{i}"].to(dt).contiguous(), True,
            eps)
        grads[f"gd{i}"], grads[f"bd{i}"] = sD[:, 1], sD[:, 0]
        # depthwise link (bnE relu6 -> dw)
        pnD = _bnbwd_pack(mD, vD, p[f"gd{i}"], sD[:, 0], sD[:, 1], m_out)
        bnE = _bn_pack(mE, vE, p[f"ge{i}"], p[f"be{i}"])
        dw_bwd = run_dw_bwd if stride == 1 else run_dw_s2_bwd
        gyE, sE, grads[f"k{i}"] = dw_bwd(gyD, aD, aE, pnD, bnE,
                                         p[f"k{i}"].to(pdt).contiguous(),
                                         True, eps)
        grads[f"ge{i}"], grads[f"be{i}"] = sE[:, 1], sE[:, 0]
        # expand link (identity input BN: x_in is finished)
        pnE = _bnbwd_pack(mE, vE, p[f"ge{i}"], sE[:, 0], sE[:, 1], m_in)
        G, _, grads[f"we{i}"] = run_pw_bwd(gyE, aE, x_in, pnE, None,
                                           p[f"we{i}"].to(dt).contiguous(),
                                           False, eps)
        if res:
            G = (G.to(pdt) + g_blk).to(dt)
        if i == 1:
            # the low_level tap's cotangent joins at the f3/f4 boundary
            G = (G.to(pdt) + g_low.contiguous()).to(dt)
    return G, {k: grads[k].to(p[k].dtype) for k in IR_KEYS}


class _FusedIRChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps, *flat):
        p = dict(zip(IR_KEYS, flat))
        out, low, stats, acts = _ir_fwd(x, p, eps)
        ctx.eps, ctx.stats, ctx.acts = eps, stats, acts
        ctx.save_for_backward(*flat)
        flat_stats = [t for blk in stats for mv in blk for t in mv]
        ctx.mark_non_differentiable(*flat_stats)
        return (out, low, *flat_stats)

    @staticmethod
    def backward(ctx, g_out, g_low, *_):
        p = dict(zip(IR_KEYS, ctx.saved_tensors))
        dx, dp = _ir_bwd(p, ctx.stats, ctx.acts, g_out, g_low, ctx.eps)
        return (dx, None, *(dp[k] for k in IR_KEYS))


def fused_ir_chain(x_nhwc, params, eps: float = EPS):
    """MobileNetV2 features[3..6] fused, training mode.

    x_nhwc: the f2 output (N, H, W, 24), finished (BN applied). params, for
    block i in 0..3: we{i} (Ce, Cin), k{i} (Ce, 9), wp{i} (Cout, Ce) and
    ge/be, gd/bd, gp/bp{i}, the BN affine pairs. Returns (f6 output at
    (H + 1) // 2, low_level = the f3 output at H, twelve (mean, var) batch
    moments ordered (E, D, P) per block)."""
    outs = _FusedIRChain.apply(x_nhwc.contiguous(), float(eps),
                               *(params[k] for k in IR_KEYS))
    return outs[0], outs[1], tuple(zip(outs[2::2], outs[3::2]))
