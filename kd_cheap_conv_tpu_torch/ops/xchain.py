"""Fused Xception-65 chains, training mode: the entry blocks, the middle flow
and the exit flow ("tail").

Counterpart of the train half of kd_cheap_conv_tpu/ops/pallas/xchain.py
(`fused_x_entry_block_train`, `fused_x_middle_train`, `fused_x_tail_train`
and their param helpers). The TPU's batch-folded (1, R, C, N*W) layout, its
row-block heights and their switches are not carried over: tensors stay
NHWC, the batch a dimension of its own. Each separable conv runs as a pass
pair of ops/stem.py (csrc/bn_passes.cu for the depthwise, the 1x1 on the
wide kernels of csrc/wide_pw.cu where it is wider than the narrow ones
take), with the train-mode BN barriers between them and the analytic
backward links in reverse:

    aD = dw(a_entry, entry BN + act, k)      # act: plain relu or none
    aP = pw(aD, bnD, W)                      # no activation after bnD

The entry BN of a chain's first conv is the identity (its input is a
finished tensor). The blocks' finishing BNs, their residual adds, the
entry blocks' 1x1/s2 skip and the exit block's 1x1 skip (conv + train BN)
run in torch, as the JAX package leaves them to XLA (xchain.py:557-561,
:913-921).

The JAX chains' backward uses `_bnbwd_identity` as the "next BN" of a
segment's last 1x1 link; it scales by rsqrt(1 + eps) = 1 - 5e-6. The port
passes None there, the exact identity.
"""

from __future__ import annotations

import torch

from .stem import (EPS, _affine, _bn_pack, _bn_train_bwd, _bnbwd_pack,
                   _count, _pdt, run_bn_dw, run_bn_dw_s2, run_bn_pw,
                   run_dw_bwd, run_dw_s2_bwd, run_pw_bwd)

NCONV = 3          # sep convs per middle block
# the exit flow's (cin, cout, entry activation) per conv (xchain.py:454):
# the exit block's three seps, then the three exit seps (relu after each,
# so it is the next conv's entry activation and the tail's finish)
TAIL_A = ((728, 728, "relu"), (728, 1024, "relu"), (1024, 1024, "relu"))
TAIL_B = ((1024, 1536, False), (1536, 1536, "relu"), (1536, 2048, "relu"))


def _dw_taps(conv):
    """(C, 1, 3, 3) depthwise weight -> (C, 9) view [dh * 3 + dw]."""
    return conv.weight.reshape(conv.weight.shape[0], 9)


def _sep_params(p, tag, s):
    """The params of one SepConvBN under the JAX package's names: k, w
    (Co, Ci), gd/bd (the depthwise BN), gp/bp (the BN after the 1x1), as
    views of the module's weights so that autograd takes the chain's
    gradients back to them."""
    sep = s.sep
    p[f"k{tag}"] = _dw_taps(sep.depthwise)
    p[f"w{tag}"] = sep.pointwise.weight[:, :, 0, 0]
    p[f"gd{tag}"], p[f"bd{tag}"] = sep.bn_dw.weight, sep.bn_dw.bias
    p[f"gp{tag}"], p[f"bp{tag}"] = s.bn.weight, s.bn.bias


def middle_train_params(blocks):
    """The middle-flow chain's param dict (xchain.py:428): per block b and
    conv i, k{b}_{i}, w{b}_{i}, gd/bd/gp/bp{b}_{i}."""
    p = {}
    for b, blk in enumerate(blocks):
        for i, s in enumerate((blk.sep1, blk.sep2, blk.sep3)):
            _sep_params(p, f"{b}_{i}", s)
    return p


def tail_train_params(exit_block, exit_seps):
    """The exit flow's param dict (xchain.py:715): keys eb0..2 (the exit
    block's seps), es0..2 (the exit seps), wsk/gsk/bsk (its skip)."""
    p = {}
    for pre, seps in (("eb", (exit_block.sep1, exit_block.sep2,
                              exit_block.sep3)),
                      ("es", tuple(exit_seps))):
        for j, s in enumerate(seps):
            _sep_params(p, f"{pre}{j}", s)
    _skip_params(p, exit_block)
    return p


def entry_block_params(blk):
    """One entry block's param dict (xchain.py:1055): keys 0..2 and
    wsk/gsk/bsk."""
    p = {}
    for i, s in enumerate((blk.sep1, blk.sep2, blk.sep3)):
        _sep_params(p, str(i), s)
    _skip_params(p, blk)
    return p


def _skip_params(p, blk):
    p["wsk"] = blk.skip_conv.weight[:, :, 0, 0]
    p["gsk"], p["bsk"] = blk.skip_bn.weight, blk.skip_bn.bias


# ---------------------------------------------------------------------------
# segments: sep convs as dw + pw pass pairs with BN barriers
# ---------------------------------------------------------------------------

def _cast(p, dt):
    """The chain's operands: 1x1 weights in the activation dtype, depthwise
    taps in the BN dtype."""
    pdt = _pdt(dt)
    return {k: (v.to(dt) if k[0] == "w" and k != "wsk"
                else v.to(pdt) if k[0] == "k" else v).contiguous()
            for k, v in p.items()}


def _seg_fwd(x, q, tags, acts_in, eps, dil, strides=None):
    """Sep convs j = 0.. with tags[j] and entry activation acts_in[j] (the
    first on the identity BN: x is finished). Returns the activations
    [x, aD0, aP0, aD1, ...] and the (mean, var) pairs [(mD0, vD0), (mP0,
    vP0), ...]."""
    a_entry, entry_bn = x, None
    acts, stats = [x], []
    for j, (tag, act) in enumerate(zip(tags, acts_in)):
        if strides is not None and strides[j] == 2:
            aD, mD, vD = run_bn_dw_s2(a_entry, entry_bn, q[f"k{tag}"], act,
                                      eps)
        else:
            aD, mD, vD = run_bn_dw(a_entry, entry_bn, q[f"k{tag}"], act, eps,
                                   dil)
        aP, mP, vP = run_bn_pw(aD, _bn_pack(mD, vD, q[f"gd{tag}"],
                                            q[f"bd{tag}"]),
                               q[f"w{tag}"], False, eps)
        acts += [aD, aP]
        stats += [(mD, vD), (mP, vP)]
        a_entry = aP
        entry_bn = _bn_pack(mP, vP, q[f"gp{tag}"], q[f"bp{tag}"])
    return acts, stats


def _seg_bwd(gy, q, tags, acts_in, acts, stats, eps, dil, dp, strides=None):
    """Backward through a _seg_fwd segment from gy = dL/d(aP of its last
    conv), already through that conv's finishing BN backward. Fills dp;
    returns dL/d(segment input)."""
    pn = None
    for j in reversed(range(len(tags))):
        tag, act = tags[j], acts_in[j]
        aD, aP, a_entry = acts[2 * j + 1], acts[2 * j + 2], acts[2 * j]
        (mD, vD), (mP, vP) = stats[2 * j], stats[2 * j + 1]
        bnD = _bn_pack(mD, vD, q[f"gd{tag}"], q[f"bd{tag}"])
        gyD, sD, dp[f"w{tag}"] = run_pw_bwd(gy, aP, aD, pn, bnD, q[f"w{tag}"],
                                            False, eps)
        dp[f"gd{tag}"], dp[f"bd{tag}"] = sD[:, 1], sD[:, 0]
        pnD = _bnbwd_pack(mD, vD, q[f"gd{tag}"], sD[:, 0], sD[:, 1],
                          float(_count(aD)))
        if j == 0:
            entry_bn = None
        else:
            mE, vE = stats[2 * j - 1]
            prev = tags[j - 1]
            entry_bn = _bn_pack(mE, vE, q[f"gp{prev}"], q[f"bp{prev}"])
        if strides is not None and strides[j] == 2:
            gy, sE, dk = run_dw_s2_bwd(gyD, aD, a_entry, pnD, entry_bn,
                                       q[f"k{tag}"], act, eps)
        else:
            gy, sE, dk = run_dw_bwd(gyD, aD, a_entry, pnD, entry_bn,
                                    q[f"k{tag}"], act, eps, dil)
        dp[f"k{tag}"] = dk
        if j > 0:
            prev = tags[j - 1]
            dp[f"gp{prev}"], dp[f"bp{prev}"] = sE[:, 1], sE[:, 0]
            pn = _bnbwd_pack(stats[2 * j - 1][0], stats[2 * j - 1][1],
                             q[f"gp{prev}"], sE[:, 0], sE[:, 1],
                             float(_count(a_entry)))
    return gy


def _skip_bn(s):
    """A skip branch's train BN moments, over the pixels of s (f32)."""
    cnt = float(_count(s))
    m = s.sum((0, 1, 2)) / cnt
    return m, (s * s).sum((0, 1, 2)) / cnt - m * m


def _finish_bwd(g, a, m, v, gamma, dt, eps):
    """A finishing BN's train backward: (ga in dt, dgamma, dbeta)."""
    ga, sg, sgx = _bn_train_bwd(g, a, m, v, gamma, eps)
    return ga.to(dt), sgx, sg


class _Chain(torch.autograd.Function):
    """One chain: `fwd(x, q, cfg)` -> (out, stats, saved), `bwd(q, cfg,
    saved, g)` -> (dx, dp); q the params cast for the passes."""

    @staticmethod
    def forward(ctx, x, fwd, bwd, cfg, keys, *flat):
        p = dict(zip(keys, flat))
        out, stats, saved = fwd(x, _cast(p, x.dtype), cfg)
        ctx.bwd, ctx.cfg, ctx.keys, ctx.saved = bwd, cfg, keys, saved
        ctx.dt = x.dtype
        ctx.save_for_backward(*flat)
        flat_stats = [t for mv in stats for t in mv]
        ctx.mark_non_differentiable(*flat_stats)
        return (out, *flat_stats)

    @staticmethod
    def backward(ctx, g, *_):
        p = dict(zip(ctx.keys, ctx.saved_tensors))
        dx, dp = ctx.bwd(_cast(p, ctx.dt), ctx.cfg, ctx.saved,
                         g.contiguous())
        return (dx, None, None, None, None,
                *(dp[k].to(p[k].dtype) for k in ctx.keys))


def _run(fwd, bwd, x, params, cfg):
    keys = tuple(params)
    outs = _Chain.apply(x.contiguous(), fwd, bwd, cfg, keys,
                        *(params[k] for k in keys))
    return outs[0], tuple(zip(outs[1::2], outs[2::2]))


# ---------------------------------------------------------------------------
# the middle flow (xchain.py:195-308)
# ---------------------------------------------------------------------------

def _mid_tags(b):
    return [f"{b}_{i}" for i in range(NCONV)]


def _xm_fwd(x, q, cfg):
    nblk, eps, dil = cfg
    dt, pdt = x.dtype, _pdt(x.dtype)
    stats, acts = [], []
    for b in range(nblk):
        tags = _mid_tags(b)
        a, st = _seg_fwd(x, q, tags, ("relu",) * NCONV, eps, dil)
        (mP, vP), last = st[-1], tags[-1]
        xn = _affine(a[-1], mP, vP, q[f"gp{last}"], q[f"bp{last}"], eps)
        x = (xn + x.to(pdt)).to(dt)
        acts.append(a)
        stats += st
    return x, stats, (acts, stats)


def _xm_bwd(q, cfg, saved, g):
    nblk, eps, dil = cfg
    acts, stats = saved
    dt, pdt = acts[0][0].dtype, _pdt(acts[0][0].dtype)
    dp = {}
    G = g.to(dt)
    for b in reversed(range(nblk)):
        tags, a = _mid_tags(b), acts[b]
        st = stats[2 * NCONV * b:2 * NCONV * (b + 1)]
        (mP, vP), last = st[-1], tags[-1]
        gy, dp[f"gp{last}"], dp[f"bp{last}"] = _finish_bwd(
            G, a[-1], mP, vP, q[f"gp{last}"], dt, eps)
        gx = _seg_bwd(gy, q, tags, ("relu",) * NCONV, a, st, eps, dil, dp)
        # conv1's entry is the identity: add the residual cotangent
        G = (gx.to(pdt) + G.to(pdt)).to(dt)
    return G, dp


def fused_x_middle_train(x_nhwc, params, nblk: int, eps: float = EPS,
                         dil: int = 1):
    """Xception middle flow, training mode (batch-moment BN).

    x_nhwc (N, H, W, C) the finished block3 output; params from
    `middle_train_params` (1x1 weights are cast to x's dtype, the rest
    computes in f32). Returns (out NHWC, per block 2 * NCONV (mean, var)
    pairs ordered (dwBN, pwBN) per conv). Gradients reach x and every
    parameter."""
    return _run(_xm_fwd, _xm_bwd, x_nhwc, params,
                (int(nblk), float(eps), int(dil)))


# ---------------------------------------------------------------------------
# the exit flow (xchain.py:544-623)
# ---------------------------------------------------------------------------

def _tail_fwd(x, q, cfg):
    dil, eps, specs = cfg
    specA, specB = specs
    dt, pdt = x.dtype, _pdt(x.dtype)
    tA, tB = [f"eb{j}" for j in range(3)], [f"es{j}" for j in range(3)]
    actsA, statsA = _seg_fwd(x, q, tA, [s[2] for s in specA], eps, dil)
    # skip branch: 1x1 conv over C + train BN, in the BN dtype
    s = torch.matmul(x.to(pdt), q["wsk"].to(pdt).t())
    msk, vsk = _skip_bn(s)
    xb = (_affine(actsA[-1], *statsA[-1], q["gpeb2"], q["bpeb2"], eps)
          + _affine(s, msk, vsk, q["gsk"], q["bsk"], eps)).to(dt)
    actsB, statsB = _seg_fwd(xb, q, tB, [s_[2] for s_ in specB], eps, dil)
    uB = _affine(actsB[-1], *statsB[-1], q["gpes2"], q["bpes2"], eps)
    out = uB.clamp_min(0.0).to(dt)
    stats = statsA + [(msk, vsk)] + statsB
    return out, stats, (actsA, s, actsB, statsA, (msk, vsk), statsB)


def _tail_bwd(q, cfg, saved, g):
    dil, eps, specs = cfg
    specA, specB = specs
    actsA, s, actsB, statsA, (msk, vsk), statsB = saved
    dt, pdt = actsA[0].dtype, _pdt(actsA[0].dtype)
    tA, tB = [f"eb{j}" for j in range(3)], [f"es{j}" for j in range(3)]
    dp = {}
    # finish B: the relu mask, then bnP_es2's backward
    uB = _affine(actsB[-1], *statsB[-1], q["gpes2"], q["bpes2"], eps)
    Gm = g.to(pdt) * (uB > 0.0)
    gaB, dp["gpes2"], dp["bpes2"] = _finish_bwd(
        Gm, actsB[-1], *statsB[-1], q["gpes2"], dt, eps)
    g_xb = _seg_bwd(gaB, q, tB, [s_[2] for s_ in specB], actsB, statsB, eps,
                    dil, dp)
    # finish A: the main branch's bnP_eb2 and the skip's BN
    Ga = g_xb.to(pdt)
    gaA, dp["gpeb2"], dp["bpeb2"] = _finish_bwd(
        Ga, actsA[-1], *statsA[-1], q["gpeb2"], dt, eps)
    gs, dp["gsk"], dp["bsk"] = _finish_bwd(Ga, s, msk, vsk, q["gsk"],
                                           Ga.dtype, eps)
    x = actsA[0]
    c = x.shape[-1]
    dp["wsk"] = gs.reshape(-1, gs.shape[-1]).t() @ x.to(pdt).reshape(-1, c)
    gx_skip = torch.matmul(gs, q["wsk"].to(pdt))
    gxA = _seg_bwd(gaA, q, tA, [s_[2] for s_ in specA], actsA, statsA, eps,
                   dil, dp)
    return (gxA.to(pdt) + gx_skip).to(dt), dp


def fused_x_tail_train(x_nhwc, params, dil: int, eps: float = EPS,
                       specs=None):
    """Xception exit flow (exit_block + 3 exit seps), training mode.

    x_nhwc (N, H, W, 728) the finished middle-flow output; params from
    `tail_train_params`; dil the exit flow's dilation (2 at OS16, 4 at
    OS8), which every depthwise pass of the flow takes. Returns (out NHWC (2048), 13 (mean, var) pairs:
    the exit block's 6, its skip's, the exit seps' 6). specs: ((cin, cout,
    act) x 3, (cin, cout, act) x 3) in place of (TAIL_A, TAIL_B), for
    narrow tests."""
    specs = specs or (TAIL_A, TAIL_B)
    return _run(_tail_fwd, _tail_bwd, x_nhwc, params,
                (int(dil), float(eps), specs))


# ---------------------------------------------------------------------------
# the entry blocks (xchain.py:875-1031)
# ---------------------------------------------------------------------------

_ENTRY_TAGS = ("0", "1", "2")
_ENTRY_STRIDES = (1, 1, 2)


def _entry_fwd(x, q, cfg):
    act1, eps = cfg
    dt, pdt = x.dtype, _pdt(x.dtype)
    acts_in = (act1, "relu", "relu")
    acts, stats = _seg_fwd(x, q, _ENTRY_TAGS, acts_in, eps, 1,
                           _ENTRY_STRIDES)
    main = _affine(acts[-1], *stats[-1], q["gp2"], q["bp2"], eps).to(dt)
    # skip: 1x1 / stride 2 conv + train BN, in the BN dtype
    s = torch.matmul(x[:, ::2, ::2, :].to(pdt), q["wsk"].to(pdt).t())
    ms, vs = _skip_bn(s)
    sk = _affine(s, ms, vs, q["gsk"], q["bsk"], eps)
    out = main + sk.to(dt)
    return out, stats + [(ms, vs)], (acts, s, stats, (ms, vs))


def _entry_bwd(q, cfg, saved, g):
    act1, eps = cfg
    acts, s, stats, (ms, vs) = saved
    x = acts[0]
    dt, pdt = x.dtype, _pdt(x.dtype)
    dp = {}
    # the skip branch's BN backward
    gs, dp["gsk"], dp["bsk"] = _finish_bwd(g.to(pdt), s, ms, vs, q["gsk"],
                                           pdt, eps)
    # the main branch: bnP2's backward at the low resolution
    gy, dp["gp2"], dp["bp2"] = _finish_bwd(g, acts[-1], *stats[-1], q["gp2"],
                                           dt, eps)
    gx = _seg_bwd(gy, q, _ENTRY_TAGS, (act1, "relu", "relu"), acts, stats,
                  eps, 1, dp, _ENTRY_STRIDES).to(pdt)
    # the skip's transpose: dx[::2, ::2] += gs . Wsk, dWsk = gs^T x[::2, ::2]
    xs = x[:, ::2, ::2, :].to(pdt)
    gx[:, ::2, ::2, :] += torch.matmul(gs, q["wsk"].to(pdt))
    dp["wsk"] = (gs.reshape(-1, gs.shape[-1]).t()
                 @ xs.reshape(-1, xs.shape[-1]))
    return gx.to(dt), dp


def fused_x_entry_block_train(x_nhwc, params, act1, eps: float = EPS):
    """One Xception entry block (sep1 and sep2 stride 1, sep3 stride 2, a
    1x1 / stride-2 skip with its own train BN), training mode.

    act1: sep1's entry activation, "relu" or False (block1's
    first_relu=False). Returns (out NHWC at (H + 1) // 2, 7 (mean, var)
    pairs: the 6 of the seps, then the skip's)."""
    return _run(_entry_fwd, _entry_bwd, x_nhwc, params, (act1, float(eps)))
