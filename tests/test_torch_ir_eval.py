"""The port's eval IR blocks (kd_cheap_conv_tpu_torch.ops.irchain_eval)
against the JAX package's Pallas eval kernels, run in interpret mode on the
CPU and called directly, on the block geometries of the 513² student at
OS16 with random BN statistics. f32, tolerance rtol = atol = 1e-4 (the two
sides sum in different orders and the JAX side folds the BNs first).

The `gpu` cases compare each CUDA kernel with its plain version on the card
and skip where there is none. JAX is imported inside the JAX-side helpers
only, so that those cases also run where JAX is not installed
(`python -m pytest --noconftest -m gpu tests/test_torch_ir_eval.py`).
"""

import numpy as np
import pytest
import torch

from kd_cheap_conv_tpu_torch.convert import state_dict_from_jax
from kd_cheap_conv_tpu_torch.models.mobilenetv2 import InvertedResidual
from kd_cheap_conv_tpu_torch.ops import irchain_eval as ire

torch.set_num_threads(1)

# name: (cin, cout, stride, dilation, expand_ratio, H = W); the OS16
# geometries of features[i], at odd and even sizes
BLOCKS = {
    "f1": (32, 16, 1, 1, 1, 17),       # no expand
    "f3": (24, 24, 1, 1, 6, 16),       # residual
    "f15": (160, 160, 1, 2, 6, 17),    # dilation 2, residual
    "f17": (160, 320, 1, 2, 6, 16),    # 160 -> 960 -> 320
    "f2": (16, 24, 2, 1, 6, 17),       # stride 2
    "f4": (24, 32, 2, 1, 6, 16),
    "f7": (32, 64, 2, 1, 6, 17),
}
TOL = dict(rtol=1e-4, atol=1e-4)


def _randomize_bn_jax(module, rng):
    from flax import nnx

    for _, m in nnx.iter_modules(module):
        if isinstance(m, nnx.BatchNorm):
            c = m.mean[...].shape[0]
            m.scale[...] = (1.0 + 0.3 * rng.randn(c)).astype(np.float32)
            m.bias[...] = (0.2 * rng.randn(c)).astype(np.float32)
            m.mean[...] = (0.3 * rng.randn(c)).astype(np.float32)
            m.var[...] = (1.0 + 0.5 * rng.rand(c)).astype(np.float32)


def jax_leaves(module) -> dict:
    """A JAX module's params and BN stats as {dotted path: numpy array}."""
    from flax import nnx

    flat = nnx.to_flat_state(nnx.state(module, nnx.Any(nnx.Param,
                                                       nnx.BatchStat)))
    return {".".join(map(str, p)): np.asarray(v[...]) for p, v in flat}


def _block_pair(name, seed=0):
    from flax import nnx

    from kd_cheap_conv_tpu.models.mobilenetv2 import \
        InvertedResidual as JaxIR

    cin, cout, s, d, t, _ = BLOCKS[name]
    jb = JaxIR(cin, cout, stride=s, dilation=d, expand_ratio=t,
               rngs=nnx.Rngs(seed))
    _randomize_bn_jax(jb, np.random.RandomState(seed + 1))
    tb = InvertedResidual(cin, cout, stride=s, dilation=d, expand_ratio=t)
    tb.load_state_dict(state_dict_from_jax(jax_leaves(jb)), strict=True)
    return jb, tb.eval()


@pytest.mark.parametrize("name", list(BLOCKS))
def test_plain_block_matches_jax_kernel(name):
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas.irchain import (fused_ir_block_s2_eval,
                                                      fused_mnv2_blocks_eval)

    cin, cout, stride, _, _, hw = BLOCKS[name]
    jb, tb = _block_pair(name)
    x = np.random.RandomState(3).randn(2, hw, hw, cin).astype(np.float32)
    if stride == 1:
        want = fused_mnv2_blocks_eval(jnp.asarray(x), (jb,), interpret=True)
        with torch.no_grad():
            got = ire.fused_mnv2_blocks_eval(torch.from_numpy(x), (tb,))
    else:
        want = fused_ir_block_s2_eval(jnp.asarray(x), jb, interpret=True)
        with torch.no_grad():
            got = ire.fused_ir_block_s2_eval(torch.from_numpy(x), tb)
    ho = (hw + 1) // 2 if stride == 2 else hw
    assert got.shape == (2, ho, ho, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["f3", "f17", "f4"])
def test_folded_weights_reproduce_block(name):
    """The BN fold the kernels consume, applied with plain ops, equals the
    unfolded block: a CPU check of what the CUDA kernels are handed."""
    import torch.nn.functional as F

    cin, cout, stride, dil, _, hw = BLOCKS[name]
    tb = InvertedResidual(cin, cout, stride=stride, dilation=dil,
                          expand_ratio=6)
    rng = np.random.RandomState(5)
    for m in tb.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            m.weight.data = torch.from_numpy((1 + 0.3 * rng.randn(c)).astype(np.float32))
            m.bias.data = torch.from_numpy((0.2 * rng.randn(c)).astype(np.float32))
            m.running_mean = torch.from_numpy((0.3 * rng.randn(c)).astype(np.float32))
            m.running_var = torch.from_numpy((1 + 0.5 * rng.rand(c)).astype(np.float32))
    tb.eval()
    p = ire.fold_ir_eval(tb, torch.float32)
    x = torch.from_numpy(rng.randn(2, hw, hw, cin).astype(np.float32))
    h = torch.clamp(x @ p.we.t() + p.be, 0, 6).permute(0, 3, 1, 2)
    k = p.kd.reshape(-1, 1, 3, 3)
    h = F.conv2d(h, k, None, stride, dil, dil, groups=k.shape[0])
    h = torch.clamp(h + p.bd[:, None, None], 0, 6).permute(0, 2, 3, 1)
    y = h @ p.wp.t() + p.bp
    if tb.use_res_connect:
        y = y + x
    with torch.no_grad():
        want = ire.fused_mnv2_blocks_eval_ref(x, (tb,))
    np.testing.assert_allclose(y.numpy(), want.numpy(), **TOL)
    assert ire.fold_ir_eval(tb, torch.float32) is p      # cached
    with torch.no_grad():
        tb.pw_bn.running_var.mul_(2.0)
    assert ire.fold_ir_eval(tb, torch.float32) is not p  # refolded


def _block_geometries(os_, size):
    """(cin, ce, cout, stride, dil, expand, h) of features[1:] of the
    MobileNetV2 backbone at output stride os_ for a size x size image."""
    from kd_cheap_conv_tpu_torch.models.mobilenetv2 import MobileNetV2

    out, h = [], (size - 1) // 2 + 1
    for f in list(MobileNetV2(output_stride=os_).features)[1:]:
        conv = f.body[-1].conv
        s, d = conv.stride[0], conv.dilation[0]
        out.append((f.body[0].conv.in_channels, conv.in_channels,
                    f.pw_linear.out_channels, s, d, len(f.body) == 2, h))
        h = (h - 1) // s + 1
    return out


@pytest.mark.parametrize("os_", [8, 16])
def test_tile_plan_fits_shared_memory(os_):
    """Every block of the 513² backbone at OS8 and OS16 gets a tile that
    fits the H100's shared memory: the float32 kernel's plan_tiles and the
    bfloat16 kernel's plan_bf16."""
    for cin, ce, cout, s, d, expand, h in _block_geometries(os_, 513):
        ho = (h - 1) // s + 1
        th, tw, ch, smem = ire.plan_tiles(4, ho, ho, cin, cout, s, d, expand)
        assert smem <= ire.SMEM_LIMIT and th * tw >= 8 and ch >= 8
        th, tw, ch, *_, smem = ire.plan_bf16(4, h, h, cin, ce, cout, s, d,
                                             expand)
        assert smem <= ire.SMEM_LIMIT and th * tw >= 8 and ch >= 16


@pytest.mark.parametrize("size", [513, 257, 769])
@pytest.mark.parametrize("os_", [8, 16])
def test_bf16_plan_meets_kernel_constraints(os_, size):
    """The bf16 plan of every block geometry (513² and the TTA scales 0.5
    and 1.5, batch 4, OS8 and OS16) passes what kdcc_ir_block_eval_bf16
    checks before it launches: chunks of 16k dividing ce at least twice,
    a warp split in 1..16 with at most 3 x 3 project sub-tiles a warp, a
    grid of at most one wave that the tiles fill, and shared memory equal
    to the layout of the plan (resident weights or a ring of 3) within the
    card's 227 KB; one plan per shape (cached)."""
    for cin, ce, cout, s, d, expand, h in _block_geometries(os_, size):
        plan = ire.plan_bf16(4, h, h, cin, ce, cout, s, d, expand)
        th, tw, ch, wn, resident, grid, smem = plan
        assert ire.plan_bf16(4, h, h, cin, ce, cout, s, d, expand) is plan
        ho = (h - 1) // s + 1
        ntiles = 4 * -(-ho // th) * -(-ho // tw)
        assert th >= 1 and tw >= 1 and 1 <= grid <= min(ntiles, ire.IRB_CTAS)
        assert grid == min(ntiles, ire.IRB_CTAS)
        assert ch % 16 == 0 and ce % ch == 0 and ce // ch >= 2 and ch <= 128
        assert wn in (1, 2, 4, 8, 16)
        mt, nt = -(-(th * tw) // 16), cout // 8
        assert -(-mt // (ire.IRB_WARPS // wn)) <= ire.IRB_MAX_M
        assert -(-nt // wn) <= ire.IRB_MAX_N
        xsl = 2 if grid < ntiles else 1
        wsl = ce // ch if resident else ire.IRB_RING
        assert resident or ce // ch > ire.IRB_RING
        assert smem == ire.bf16_smem(th, tw, ch, s, d, cin, cout, expand,
                                     xsl, wsl) <= ire.SMEM_LIMIT


@pytest.mark.parametrize("name,ch", [("f3", 48), ("f17", 48), ("f1", 16)])
def test_bf16_weights_hold_each_chunk_contiguous(name, ch):
    """bf16_weights lays the folded 1x1 weights out as the kernel's slots
    hold a chunk: We's rows padded to r16(cin) + 8 with zeros, Wp
    chunk-major (ce / ch, cout, ch + 8) with zeros past ch; cached."""
    cin, cout, stride, dil, t, _ = BLOCKS[name]
    tb = InvertedResidual(cin, cout, stride=stride, dilation=dil,
                          expand_ratio=t).eval()
    p = ire.fold_ir_eval(tb, torch.bfloat16)
    wex, wpc = ire.bf16_weights(tb, p, ch)
    ce = p.kd.shape[0]
    assert wpc.shape == (ce // ch, cout, ch + 8)
    for c in range(ce // ch):
        assert torch.equal(wpc[c, :, :ch], p.wp[:, c * ch:(c + 1) * ch])
    assert not wpc[:, :, ch:].any()
    if p.we is None:
        assert wex is None
    else:
        kx = (cin + 15) // 16 * 16
        assert wex.shape == (ce, kx + 8) and torch.equal(wex[:, :cin], p.we)
        assert not wex[:, cin:].any()
    assert ire.bf16_weights(tb, p, ch)[1] is wpc


def test_bf16_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="8 channels"):
        ire.plan_bf16(1, 17, 17, 12, 72, 24, 1, 1, True)
    with pytest.raises(ValueError, match="8 channels"):
        ire.plan_bf16(1, 17, 17, 16, 24, 16, 1, 1, True)
    with pytest.raises(ValueError, match="8 channels"):
        ire.plan_bf16(1, 17, 17, 16, 32, 16, 1, 1, False)
    with pytest.raises(ValueError, match="stride 2, dil 2"):
        ire.plan_bf16(1, 17, 17, 16, 96, 24, 2, 2, True)
    # a hidden width of 16 is one chunk
    assert ire.plan_bf16(1, 17, 17, 16, 16, 16, 1, 1, False)[2] == 16


def test_wrappers_reject_wrong_block_kind():
    _, tb2 = _block_pair("f2")
    x = torch.zeros(1, 8, 8, 16)
    with pytest.raises(ValueError):
        ire.fused_mnv2_blocks_eval(x, (tb2,))
    tb1 = InvertedResidual(24, 24, stride=1, expand_ratio=6)
    with pytest.raises(ValueError):
        ire.fused_ir_block_s2_eval(torch.zeros(1, 8, 8, 24), tb1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_kernel_matches_plain_on_card(cuda, name, dtype):
    cin, cout, stride, dil, t, hw = BLOCKS[name]
    torch.manual_seed(0)
    tb = InvertedResidual(cin, cout, stride=stride, dilation=dil,
                          expand_ratio=t).eval()
    for m in tb.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.3)
            m.running_var.uniform_(1.0, 1.5)
    tb = tb.to(cuda)
    x = torch.randn(2, hw, hw, cin, device=cuda).to(dtype)
    with torch.no_grad():
        if stride == 1:
            got = ire.fused_mnv2_blocks_eval(x, (tb,))
            want = ire.fused_mnv2_blocks_eval_ref(x, (tb,))
        else:
            got = ire.fused_ir_block_s2_eval(x, tb)
            want = ire.fused_ir_block_s2_eval_ref(x, tb)
    torch.cuda.synchronize()
    tol = TOL if dtype == torch.float32 else dict(rtol=5e-2, atol=1e-1)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


# on the card only: dilation 4 (OS8's last stage) and 3 (the bf16 kernel's
# run-time dilation), ragged tile edges, and CTAs that walk several tiles
# with resident (f8) and streamed (f12, f17) weights:
# (cin, cout, stride, dilation, expand_ratio, H = W, batch)
CARD_BLOCKS = {
    "os8_f16_d4": (160, 160, 1, 4, 6, 23, 2),
    "os8_f17_d4": (160, 320, 1, 4, 6, 29, 2),
    "d3": (32, 32, 1, 3, 6, 19, 2),
    "f1_ragged": (32, 16, 1, 1, 1, 37, 2),
    "f2_ragged": (16, 24, 2, 1, 6, 31, 2),
    "f8_65_walk": (64, 64, 1, 1, 6, 65, 4),
    "f12_65_walk": (96, 96, 1, 1, 6, 65, 4),
    "f17_65_walk": (160, 320, 1, 2, 6, 65, 4),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(BLOCKS) + list(CARD_BLOCKS))
def test_kernel_is_bit_identical_twice_and_matches_plain(cuda, name, dtype):
    """Each kernel call gives the same bits as the one before, and the
    plain version's values within the dtype's tolerance, on the BLOCKS
    geometries and on CARD_BLOCKS'."""
    cin, cout, stride, dil, t, hw, *nb = {**BLOCKS, **CARD_BLOCKS}[name]
    torch.manual_seed(1)
    tb = InvertedResidual(cin, cout, stride=stride, dilation=dil,
                          expand_ratio=t).eval()
    for m in tb.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.3)
            m.running_var.uniform_(1.0, 1.5)
    tb = tb.to(cuda)
    x = torch.randn(nb[0] if nb else 2, hw, hw, cin, device=cuda).to(dtype)
    with torch.no_grad():
        if stride == 1:
            a = ire.fused_mnv2_blocks_eval(x, (tb,))
            b = ire.fused_mnv2_blocks_eval(x, (tb,))
            want = ire.fused_mnv2_blocks_eval_ref(x, (tb,))
        else:
            a = ire.fused_ir_block_s2_eval(x, tb)
            b = ire.fused_ir_block_s2_eval(x, tb)
            want = ire.fused_ir_block_s2_eval_ref(x, tb)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    tol = TOL if dtype == torch.float32 else dict(rtol=5e-2, atol=1e-1)
    np.testing.assert_allclose(a.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.gpu
def test_bf16_kernel_rejects_misaligned_input(cuda):
    tb = InvertedResidual(24, 24, stride=1, expand_ratio=6).eval().to(cuda)
    n = 2 * 16 * 16 * 24
    x = torch.zeros(n + 1, device=cuda, dtype=torch.bfloat16)[1:]
    with torch.no_grad(), pytest.raises(ValueError, match="16-byte"):
        ire.fused_mnv2_blocks_eval(x.view(2, 16, 16, 24), (tb,))


@pytest.mark.gpu
def test_kernels_reject_wrong_block_kind_on_card(cuda):
    tb2 = InvertedResidual(16, 24, stride=2, expand_ratio=6).eval().to(cuda)
    tb1 = InvertedResidual(24, 24, stride=1, expand_ratio=6).eval().to(cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match="stride-1"):
            ire.fused_mnv2_blocks_eval(torch.zeros(1, 8, 8, 16, device=cuda),
                                       (tb2,))
        with pytest.raises(ValueError, match="stride-2"):
            ire.fused_ir_block_s2_eval(torch.zeros(1, 8, 8, 24, device=cuda),
                                       tb1)
