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


@pytest.mark.parametrize("os_", [8, 16])
def test_tile_plan_fits_shared_memory(os_):
    """Every block of the 513² backbone at OS8 and OS16, both dtypes, gets
    a tile that fits the H100's shared memory."""
    from kd_cheap_conv_tpu_torch.models.mobilenetv2 import MobileNetV2

    m = MobileNetV2(output_stride=os_)
    h = 257
    for f in list(m.features)[1:]:
        conv = f.body[-1].conv
        s, d = conv.stride[0], conv.dilation[0]
        cin = f.body[0].conv.in_channels
        ho = (h - 1) // s + 1
        for esize in (4, 2):
            th, tw, ch, smem = ire.plan_tiles(4, ho, ho, cin,
                                              f.pw_linear.out_channels, s, d,
                                              esize, len(f.body) == 2)
            assert smem <= ire.SMEM_LIMIT and th * tw >= 8 and ch >= 8
        h = ho


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
