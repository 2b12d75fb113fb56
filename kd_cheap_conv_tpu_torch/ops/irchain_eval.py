"""Eval-mode MobileNetV2 inverted-residual blocks, BN folded (serving path).

Counterpart of the eval half of kd_cheap_conv_tpu/ops/pallas/irchain.py:

- `fused_mnv2_blocks_eval(x_nhwc, blocks)` runs consecutive stride-1 blocks,
  one launch of kernel A per block (csrc/ir_block_eval.cu, stride 1);
- `fused_ir_block_s2_eval(x_nhwc, block)` runs one stride-2 block with
  kernel B (the same source, stride 2, pad 1, output (H + 1) // 2).

Both take and return NHWC-contiguous tensors, as the JAX functions do. A
CUDA tensor launches the kernel (or the call raises); a CPU tensor takes the
plain PyTorch version beside it (`*_ref`: F.conv2d + F.batch_norm in eval +
clamp(0, 6) on the block's own unfolded weights), which the CPU tests hold
against the JAX kernels. Each wrapper counts its kernel launches in its
`launches` attribute.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .foldcache import cached_fold

# H100: the per-block opt-in limit of dynamic shared memory.
SMEM_LIMIT = 232_448
# float32 (the parity kernel, one CTA per tile): output tiles and hidden
# chunks, largest first
_TILES = ((8, 8), (8, 4), (4, 4), (2, 4))
_CHUNKS = (32, 16, 8)
# bfloat16 (csrc/ir_block_eval.cu namespace irb): CTAs of 512 threads (16
# warps), one an SM, at most one wave; a warp holds at most 3 x 3 of the
# project's 16 x 8 sub-tiles; a thread's depthwise segment is 4 outputs; a
# streamed weight ring has 3 slots
IRB_WARPS, IRB_CTAS = 16, 132
IRB_MAX_M = IRB_MAX_N = 3
IRB_SEG, IRB_RING = 4, 3
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ir_block_fusable(f) -> bool:
    """Stride-1 inverted residual the eval kernel takes: [1x1 expand] ->
    3x3 depthwise -> 1x1 project, no conv biases."""
    try:
        d = f.body[-1].conv
        return (d.kernel_size == (3, 3) and d.stride == (1, 1)
                and d.groups == d.in_channels and d.bias is None
                and f.pw_linear.kernel_size == (1, 1)
                and f.pw_linear.bias is None
                and (len(f.body) == 1
                     or (f.body[0].conv.kernel_size == (1, 1)
                         and f.body[0].conv.groups == 1)))
    except AttributeError:
        return False


def ir_block_s2_fusable(f) -> bool:
    """Stride-2, dilation-1 inverted residual (no residual connection)."""
    try:
        d = f.body[-1].conv
        return (d.kernel_size == (3, 3) and d.stride == (2, 2)
                and d.dilation == (1, 1) and d.groups == d.in_channels
                and d.bias is None and not f.use_res_connect
                and f.pw_linear.kernel_size == (1, 1)
                and f.pw_linear.bias is None
                and (len(f.body) == 1
                     or (f.body[0].conv.kernel_size == (1, 1)
                         and f.body[0].conv.groups == 1)))
    except AttributeError:
        return False


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _bn_eval(x, bn):
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps)


def _ir_block_ref(x_nchw, f):
    dt = x_nchw.dtype
    h = x_nchw
    for m in f.body:
        c = m.conv
        h = F.conv2d(h, c.weight.to(dt), None, c.stride, c.padding,
                     c.dilation, c.groups)
        h = torch.clamp(_bn_eval(h, m.bn), 0.0, 6.0)
    h = _bn_eval(F.conv2d(h, f.pw_linear.weight.to(dt)), f.pw_bn)
    return x_nchw + h if f.use_res_connect else h


def fused_mnv2_blocks_eval_ref(x_nhwc, blocks):
    """Plain version of kernel A: the blocks' own convs and eval BNs."""
    x = x_nhwc.permute(0, 3, 1, 2)
    for f in blocks:
        x = _ir_block_ref(x, f)
    return x.permute(0, 2, 3, 1).contiguous()


def fused_ir_block_s2_eval_ref(x_nhwc, f):
    """Plain version of kernel B."""
    return fused_mnv2_blocks_eval_ref(x_nhwc, (f,))


# ---------------------------------------------------------------------------
# BN folding and tiling (host side of the kernels)
# ---------------------------------------------------------------------------

class FoldedIR(NamedTuple):
    we: torch.Tensor | None    # (Ce, Cin) activation dtype
    be: torch.Tensor | None    # (Ce,) f32
    kd: torch.Tensor           # (Ce, 9) f32
    bd: torch.Tensor           # (Ce,) f32
    wp: torch.Tensor           # (Cout, Ce) activation dtype
    bp: torch.Tensor           # (Cout,) f32
    dil: int
    cout: int
    stride: int                # 1 (kernel A), 2 (kernel B), 0 (neither)


def _bn_fold(bn):
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return s, bn.bias.float() - bn.running_mean.float() * s


def _fold_inputs(f) -> list:
    """Every tensor the fold reads, in a fixed order."""
    pairs = [(m.conv, m.bn) for m in f.body] + [(f.pw_linear, f.pw_bn)]
    return [t for conv, bn in pairs for t in (conv.weight, bn.weight, bn.bias,
                                               bn.running_mean,
                                               bn.running_var)]


def fold_ir_eval(f, dtype) -> FoldedIR:
    """Fold the block's eval BNs into its convs, as `_fold_ir_eval` does:
    the 1x1 weights are scaled in f32 and then cast to the activation dtype;
    the dw taps and all biases stay f32. Cached on the block
    (ops/foldcache.py)."""
    def build():
        we = be = None
        if len(f.body) == 2:
            e = f.body[0]
            s, be = _bn_fold(e.bn)
            we = (e.conv.weight.float()[:, :, 0, 0] * s[:, None]).to(dtype)
        d = f.body[-1]
        s, bd = _bn_fold(d.bn)
        kd = (d.conv.weight.float().reshape(-1, 9) * s[:, None]).contiguous()
        s, bp = _bn_fold(f.pw_bn)
        wp = f.pw_linear.weight.float()[:, :, 0, 0] * s[:, None]
        stride = 1 if ir_block_fusable(f) else 2 if ir_block_s2_fusable(f) else 0
        return FoldedIR(we if we is None else we.contiguous(), be, kd,
                        bd.contiguous(), wp.to(dtype).contiguous(),
                        bp.contiguous(), int(d.conv.dilation[0]),
                        int(wp.shape[0]), stride)

    return cached_fold(f, "_kdcc_folded", _fold_inputs(f), dtype, build)


def _r16(v):
    return (v + 15) // 16 * 16


def _up128(b):
    return (b + 127) // 128 * 128


def smem_bytes(th, tw, ch, stride, dil, cin, cout, expand) -> int:
    """Dynamic shared memory of one CTA of the float32 kernel; the layout
    of f32k::smem_layout in csrc/ir_block_eval.cu, which checks that the
    two agree."""
    hp = ((th - 1) * stride + 2 * dil + 1) * ((tw - 1) * stride + 2 * dil + 1)
    op = th * tw
    parts = [hp * cin * 4, cin * ch * 4 if expand else 0, hp * ch * 4,
             op * ch * 4, ch * cout * 4, op * cout * 4]
    return sum(_r16(b) for b in parts)


def plan_tiles(n, ho, wo, cin, cout, stride, dil, expand,
               num_sms=132) -> tuple[int, int, int, int]:
    """(th, tw, ch, smem) of one float32 launch: the largest output tile
    whose widest hidden chunk fits shared memory, shrunk while the grid
    holds fewer CTAs than the card has SMs."""
    best = None
    for th, tw in _TILES:
        for ch in _CHUNKS:
            smem = smem_bytes(th, tw, ch, stride, dil, cin, cout, expand)
            if smem <= SMEM_LIMIT:
                best = (th, tw, ch, smem)
                break
        else:
            continue
        if n * math.ceil(ho / th) * math.ceil(wo / tw) >= num_sms:
            return best
    if best is None:
        raise ValueError(f"no tile fits shared memory: cin={cin} "
                         f"cout={cout} dil={dil}")
    return best


def bf16_smem(th, tw, ch, stride, dil, cin, cout, expand, xsl, wsl) -> int:
    """Dynamic shared memory of one CTA of the bf16 kernel: irb::layout in
    csrc/ir_block_eval.cu, which recomputes it from the plan and refuses
    another total. xsl x-halo slots of [r16(hp)][r16(cin) + 8] bf16; wsl
    weight slots of We [ch][r16(cin) + 8], Wp [cout][ch + 8] bf16, the
    taps [ch][9], bd and be [ch] f32; es [hp][ch + 8] f32 (with an
    expand); ds [r16(th tw)][ch + 8] bf16; an mbarrier a weight slot; each
    region 128-byte aligned."""
    hh = (th - 1) * stride + 2 * dil + 1
    hw = (tw - 1) * stride + 2 * dil + 1
    hp, ldx, ldc = hh * hw, _r16(cin) + 8, ch + 8
    wslot = ((_up128(ch * ldx * 2) if expand else 0) + _up128(cout * ldc * 2)
             + _up128(ch * 36) + _up128(ch * 4)
             + (_up128(ch * 4) if expand else 0))
    return (xsl * _up128(_r16(hp) * ldx * 2) + wsl * wslot
            + (_up128(hp * ldc * 4) if expand else 0)
            + _up128(_r16(th * tw) * ldc * 2) + _up128(8 * wsl))


def bf16_weights(f, p, ch):
    """The bf16 kernel's copies of the folded 1x1 weights p.we, p.wp,
    laid out as its shared-memory slots hold a chunk of ch hidden channels,
    so that each chunk is one contiguous block (one bulk copy): We as
    (ce, r16(cin) + 8), Wp chunk-major as (ce / ch, cout, ch + 8), zero in
    the padding columns. Cached on the block beside the fold p it was made
    from, per ch; a new fold makes new copies."""
    cache = f.__dict__.setdefault("_kdcc_irb_w", {})
    hit = cache.get(ch)
    if hit is not None and hit[0] is p:
        return hit[1]
    with torch.no_grad():
        ce = p.kd.shape[0]
        wex = None
        if p.we is not None:
            cin = p.we.shape[1]
            wex = p.we.new_zeros((ce, _r16(cin) + 8))
            wex[:, :cin] = p.we
        wpc = p.wp.new_zeros((ce // ch, p.cout, ch + 8))
        wpc[:, :, :ch] = p.wp.view(p.cout, ce // ch, ch).transpose(0, 1)
    cache[ch] = (p, (wex, wpc))
    return wex, wpc


def _warp_split(mt, nt):
    """The project's split over the 16 warps of the bf16 kernel: warp w
    holds m-tiles w // wn + i * (16 // wn) and n-tiles (w % wn) * nper + j.
    The first wn in 1, 2, 4, 8, 16 with the fewest sub-tiles a warp, at
    most IRB_MAX_M x IRB_MAX_N; None if no wn keeps within that."""
    best = None
    for wn in (1, 2, 4, 8, 16):
        mper, nper = -(-mt // (IRB_WARPS // wn)), -(-nt // wn)
        if mper <= IRB_MAX_M and nper <= IRB_MAX_N and (
                best is None or mper * nper < best[1]):
            best = (wn, mper * nper)
    return None if best is None else best[0]


@functools.lru_cache(maxsize=None)
def plan_bf16(n, h, w, cin, ce, cout, stride, dil, expand):
    """The bf16 kernel's plan for one block shape, from the shape alone:
    (th, tw, ch, wn, resident, grid, smem). Over output tiles up to 16 x 32
    and hidden chunks ch (multiples of 16 dividing ce at least twice, at
    most 128; ce itself where there is none) it takes the least estimated time: waves of tiles on at most
    IRB_CTAS CTAs, times a tile's tensor-core MACs (expand over the padded
    halo, project over the padded tile), depthwise FMAs (weighted 32, the
    CUDA cores' rate), copied bytes (weighted 8: the halo per tile, the
    weights per tile when they stream) and a fixed cost per chunk and per
    tile (barriers). The weights stay resident when they take at most 3
    slots, or when a CTA walks several tiles and they fit. Ties keep the
    first found (smaller tiles, then smaller chunks)."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    if (cin % 8 or cout % 8 or ce % 16 or (not expand and ce != cin)
            or stride not in (1, 2) or dil < 1 or (stride == 2 and dil != 1)):
        raise ValueError(f"the bfloat16 kernel moves 8 channels per access: "
                         f"it needs cin and cout divisible by 8 and the "
                         f"hidden width by 16 (got {cin}->{ce}->{cout}, "
                         f"stride {stride}, dil {dil})")
    kx = _r16(cin)
    chunks = [c for c in range(16, min(128, ce // 2) + 1, 16)
              if ce % c == 0] or [ce]
    best = None
    for th in range(1, 17):
        for tw in range(1, 33):
            ntiles = n * -(-ho // th) * -(-wo // tw)
            grid = min(ntiles, IRB_CTAS)
            waves, xsl = -(-ntiles // grid), 2 if grid < ntiles else 1
            wn = _warp_split(_r16(th * tw) // 16, cout // 8)
            if wn is None:
                continue
            hh = (th - 1) * stride + 2 * dil + 1
            hw = (tw - 1) * stride + 2 * dil + 1
            hp, op = hh * hw, th * tw
            macs = ((_r16(hp) * kx * ce if expand else 0)
                    + _r16(op) * ce * cout
                    + 32 * th * -(-tw // IRB_SEG) * IRB_SEG * ce)
            wbytes = ce * ((kx if expand else 0) + cout) * 2
            for ch in chunks:
                nch = ce // ch
                resident = nch <= IRB_RING or (
                    xsl == 2 and bf16_smem(th, tw, ch, stride, dil, cin, cout,
                                           expand, xsl, nch) <= SMEM_LIMIT)
                smem = bf16_smem(th, tw, ch, stride, dil, cin, cout, expand,
                                 xsl, nch if resident else IRB_RING)
                if smem > SMEM_LIMIT:
                    continue
                cost = (waves * (macs + 8 * hp * cin * 2 + nch * 2 ** 18
                                 + 2 ** 19 + (0 if resident else 8 * wbytes))
                        + (8 * wbytes if resident else 0))
                if best is None or cost < best[0]:
                    best = (cost, (th, tw, ch, wn, int(resident), grid, smem))
    if best is None:
        raise ValueError(f"no bf16 plan fits shared memory: {cin}->{ce}->"
                         f"{cout}, stride {stride}, dil {dil}")
    return best[1]


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _stream(x):
    idx = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    return idx, torch.cuda.current_stream(idx).cuda_stream


def _launch(x, f, stride):
    from .. import native

    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in f.parameters())):
        raise RuntimeError("the eval IR kernels are forward-only: call them "
                           "under torch.no_grad() or inference_mode()")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"eval IR kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("eval IR kernel takes an NHWC-contiguous 4-D tensor")
    n, h, w, cin = x.shape
    p = fold_ir_eval(f, x.dtype)
    if p.stride != stride:
        raise ValueError(f"block is not a stride-{stride} inverted residual")
    ce = p.kd.shape[0]
    expand = p.we is not None
    if p.kd.device != x.device:
        raise ValueError(f"block weights on {p.kd.device}, input on "
                         f"{x.device}")
    if (expand and p.we.shape[1] != cin) or (not expand and ce != cin):
        raise ValueError(f"input has {cin} channels, the block takes "
                         f"{p.we.shape[1] if expand else ce}")
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    y = torch.empty((n, ho, wo, p.cout), dtype=x.dtype, device=x.device)
    res = int(f.use_res_connect)
    dev, stream = _stream(x)
    we = p.we.data_ptr() if expand else None
    be = p.be.data_ptr() if expand else None
    if x.dtype == torch.bfloat16:
        if x.data_ptr() % 16 or y.data_ptr() % 16:
            raise ValueError("the bfloat16 kernel moves 8 channels per "
                             "access: it needs 16-byte aligned tensors")
        th, tw, ch, wn, resident, grid, smem = plan_bf16(
            n, h, w, cin, ce, p.cout, stride, p.dil, expand)
        wex, wpc = bf16_weights(f, p, ch)
        err = native.library().kdcc_ir_block_eval_bf16(
            x.data_ptr(), wex.data_ptr() if expand else None, be,
            p.kd.data_ptr(), p.bd.data_ptr(), wpc.data_ptr(),
            p.bp.data_ptr(), y.data_ptr(), n, h, w, cin, ce,
            p.cout, stride, p.dil, int(expand), res, th, tw, ch, wn, resident,
            grid, smem, dev, stream)
    else:
        th, tw, ch, smem = plan_tiles(n, ho, wo, cin, p.cout, stride, p.dil,
                                      expand)
        err = native.library().kdcc_ir_block_eval(
            x.data_ptr(), we, be, p.kd.data_ptr(), p.bd.data_ptr(),
            p.wp.data_ptr(), p.bp.data_ptr(), y.data_ptr(), n, h, w, cin, ce,
            p.cout, stride, p.dil, int(expand), res, th, tw, ch, smem, dev,
            stream)
    native.check(err, f"ir_block_eval (stride {stride}, {cin}->{ce}->"
                      f"{p.cout}, dil {p.dil})")
    return y


def _require_cuda(x):
    if x.device.type != "cuda":
        raise ValueError(f"eval IR kernels run on CUDA or CPU tensors, got "
                         f"{x.device}")


def fused_mnv2_blocks_eval(x_nhwc, blocks):
    """Run consecutive stride-1 InvertedResiduals in eval mode, one kernel A
    launch per block (only each block's input and output touch memory)."""
    if x_nhwc.device.type == "cpu":
        if not all(ir_block_fusable(f) for f in blocks):
            raise ValueError("block is not a stride-1 inverted residual")
        return fused_mnv2_blocks_eval_ref(x_nhwc, blocks)
    _require_cuda(x_nhwc)
    for f in blocks:
        x_nhwc = _launch(x_nhwc, f, 1)
        fused_mnv2_blocks_eval.launches += 1
    return x_nhwc


def fused_ir_block_s2_eval(x_nhwc, f):
    """One stride-2 InvertedResidual in eval mode with kernel B."""
    if x_nhwc.device.type == "cpu":
        if not ir_block_s2_fusable(f):
            raise ValueError("block is not a stride-2 inverted residual")
        return fused_ir_block_s2_eval_ref(x_nhwc, f)
    _require_cuda(x_nhwc)
    y = _launch(x_nhwc, f, 2)
    fused_ir_block_s2_eval.launches += 1
    return y


fused_mnv2_blocks_eval.launches = 0
fused_ir_block_s2_eval.launches = 0
