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

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .foldcache import cached_fold

# H100: the per-block opt-in limit of dynamic shared memory.
SMEM_LIMIT = 232_448
_TILES = ((8, 8), (8, 4), (4, 4), (2, 4))
# hidden-channel chunks, widest first; the tensor-core path (bfloat16) takes
# multiples of 16 and keeps to half an SM's shared memory, so that two CTAs
# share an SM (chosen from a device-time sweep on an H100, PERF.md)
_CHUNKS = {2: (96, 64, 32, 16), 4: (32, 16, 8)}
_SMEM_BUDGET = {2: SMEM_LIMIT // 2, 4: SMEM_LIMIT}
# bfloat16: the project accumulators of a tile are in registers, at most
# this many 16x8 fragments per CTA (kWarps * kAccTiles in the .cu)
_ACC_TILES = 80
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


def smem_bytes(th, tw, ch, stride, dil, cin, cout, esize, expand) -> int:
    """Dynamic shared memory of one CTA; the same layout as smem_layout()
    in csrc/ir_block_eval.cu, which checks that the two agree. bfloat16
    (esize 2) uses the tensor-core layout: rows padded to 16, input
    channels to 16, output channels to 8, row strides +8 elements, and
    keeps the project accumulators in registers."""
    def r16(b):
        return (b + 15) // 16 * 16

    def up(v, m):
        return (v + m - 1) // m * m

    hp = ((th - 1) * stride + 2 * dil + 1) * ((tw - 1) * stride + 2 * dil + 1)
    op = th * tw
    if esize == 2:
        hp, op, kx, cp = up(hp, 16), up(op, 16), up(cin, 16), up(cout, 8)
        parts = [hp * (kx + 8) * 2, ch * (kx + 8) * 2 if expand else 0,
                 hp * (ch + 8) * 4, op * (ch + 8) * 2, cp * (ch + 8) * 2]
    else:
        parts = [hp * cin * esize, cin * ch * esize if expand else 0,
                 hp * ch * 4, op * ch * esize, ch * cout * esize,
                 op * cout * 4]
    return sum(r16(b) for b in parts)


def plan_tiles(n, ho, wo, cin, cout, stride, dil, esize, expand,
               num_sms=132) -> tuple[int, int, int, int]:
    """(th, tw, ch, smem) for one launch: the largest output tile whose
    widest hidden chunk fits the dtype's shared-memory budget, shrunk while
    the grid holds fewer CTAs than the card has SMs."""
    best = None
    for th, tw in _TILES:
        if esize == 2 and (-(-th * tw // 16)) * (-(-cout // 8)) > _ACC_TILES:
            continue
        for ch in _CHUNKS[esize]:
            smem = smem_bytes(th, tw, ch, stride, dil, cin, cout, esize,
                              expand)
            if smem <= _SMEM_BUDGET[esize]:
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


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

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
    if x.dtype == torch.bfloat16 and (
            cin % 8 or ce % 16 or p.cout % 8 or any(
                t.data_ptr() % 16 for t in (x, y, p.wp, *([p.we] if expand
                                                          else [])))):
        raise ValueError(f"the bfloat16 kernel moves 8 channels per access: "
                         f"it needs cin and cout divisible by 8, the hidden "
                         f"width by 16 and 16-byte aligned tensors (got "
                         f"{cin}->{ce}->{p.cout})")
    dev = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    th, tw, ch, smem = plan_tiles(n, ho, wo, cin, p.cout, stride, p.dil,
                                  x.element_size(), expand, sms)
    res = bool(f.use_res_connect)
    err = native.library().kdcc_ir_block_eval(
        _DTYPE_CODE[x.dtype], x.data_ptr(),
        p.we.data_ptr() if expand else None,
        p.be.data_ptr() if expand else None,
        p.kd.data_ptr(), p.bd.data_ptr(), p.wp.data_ptr(), p.bp.data_ptr(),
        y.data_ptr(), n, h, w, cin, ce, p.cout, stride, p.dil, int(expand),
        int(res), th, tw, ch, smem, dev,
        torch.cuda.current_stream(dev).cuda_stream)
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
