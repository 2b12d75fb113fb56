"""The port's eval bottleneck (kd_cheap_conv_tpu_torch.ops.rchain) against
the JAX package's two Pallas versions of it, which run in interpret mode on
the CPU, and the port's ResNet-50 with it against the JAX one.

- (a) `fused_resnet_blocks_eval` (its plain version, `bneck_eval_ref`, on
  CPU tensors) against JAX `fused_resnet_blocks_eval(..., interpret=True)`
  and `fused_resnet_stage_eval_hwnc(..., interpret=True)` on a ResNet-50
  with random BN statistics (`_randomize_bns`, tests/test_pallas_rchain.py's
  helper): layer1 (its first block with the 1x1 downsample) and layer2[1:]
  at (8, 9, 11, C), batch 8 so that the hwnc version takes it. f32 to rtol
  = atol = 2e-4 (tests/test_pallas_rchain.py's limits); bf16 to a max abs
  error of 1.6e-2 of the largest JAX value: h1 and h2 are rounded to bf16
  on both sides, and a last-ulp f32 difference can round them apart.
- (b) The guards: layer2[0] (stride 2) and a dilated layer4 block are not
  fusable; in train mode, or with autograd on, neither the plain version
  nor the launch counter is reached; an in-place update of a BN's running
  statistics invalidates the cached fold.
- (c) The port's ResNet-50 in eval mode under no_grad against the JAX one
  with `use_pallas_resnet_eval` on and an active 8-device mesh (without the
  mesh the JAX side would silently run stock), batch 8, 33²: both taps to
  rtol = atol = 5e-4 (tests/test_pallas_rchain.py's model test), with 6
  plain bottleneck calls (layer1's 3, layer2's last 3).

The `gpu` cases hold the kernel against its plain version on the card and
skip where there is none.
"""

import copy
import functools

import numpy as np
import pytest
import torch

from kd_cheap_conv_tpu_torch.ops import rchain as trc

torch.set_num_threads(1)

BF16_TOL = 1.6e-2


def _randomize_bns(model, rng):
    """tests/test_pallas_rchain.py's helper: random eval statistics and
    affine parameters for every BN."""
    import jax.numpy as jnp
    from flax import nnx

    for _, m in nnx.iter_modules(model):
        if isinstance(m, nnx.BatchNorm):
            c = m.mean[...].shape[0]
            m.mean[...] = jnp.asarray(0.3 * rng.randn(c).astype(np.float32))
            m.var[...] = jnp.asarray((1 + 0.5 * rng.rand(c)).astype(
                np.float32))
            m.scale[...] = jnp.asarray(
                (1 + 0.2 * rng.randn(c)).astype(np.float32))
            m.bias[...] = jnp.asarray(0.2 * rng.randn(c).astype(np.float32))


@functools.cache
def _pair():
    """(JAX ResNet-50 in eval mode, the port's with its weights)."""
    from flax import nnx

    from kd_cheap_conv_tpu.models.resnet import resnet50 as jax_resnet50
    from kd_cheap_conv_tpu_torch.convert import state_dict_from_jax
    from kd_cheap_conv_tpu_torch.models.resnet import resnet50
    from test_torch_model import jax_leaves

    jm = nnx.jit(lambda: jax_resnet50(output_stride=16, rngs=nnx.Rngs(0)))()
    _randomize_bns(jm, np.random.RandomState(13))
    jm.eval()
    tm = resnet50(output_stride=16)
    tm.load_state_dict(state_dict_from_jax(jax_leaves(jm)), strict=True)
    return jm, tm.to(memory_format=torch.channels_last).eval()


def _stage(m, name):
    return list(m.layer1) if name == "layer1" else list(m.layer2)[1:]


# ---------------------------------------------------------------------------
# (a) the blocks against both JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stage,cin", [("layer1", 64), ("layer2", 512)])
def test_bneck_matches_both_jax_kernels(stage, cin, dtype):
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas.rchain import \
        fused_resnet_blocks_eval as jax_blocks
    from kd_cheap_conv_tpu.ops.pallas.rchain_hwnc import \
        fused_resnet_stage_eval_hwnc as jax_stage

    jm, tm = _pair()
    jb, tb = _stage(jm, stage), _stage(tm, stage)
    assert all(trc.bneck_fusable(b) and trc.bns_eval(b) for b in tb)
    assert (tb[0].downsample is not None) == (stage == "layer1")
    x = np.random.RandomState(7).randn(8, 9, 11, cin).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    wants = [np.asarray(f(xj, jb, interpret=True).astype(jnp.float32))
             for f in (jax_blocks, jax_stage)]
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    with torch.no_grad():
        got = trc.fused_resnet_blocks_eval(xt, tb).float().numpy()
    for want in wants:
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        else:
            err = float(np.abs(got - want).max())
            assert err <= BF16_TOL * float(np.abs(want).max()), err


# ---------------------------------------------------------------------------
# (b) the guards
# ---------------------------------------------------------------------------

def _count_calls(monkeypatch):
    calls = []
    orig = trc.bneck_eval_ref
    monkeypatch.setattr(trc, "bneck_eval_ref",
                        lambda *a: calls.append(1) or orig(*a))
    return calls


def test_guards_keep_strided_dilated_train_and_autograd_on_modules(
        monkeypatch):
    from kd_cheap_conv_tpu_torch.models.resnet import resnet50

    tm = resnet50(output_stride=16)
    assert all(trc.bneck_fusable(b) for b in tm.layer1)
    assert not trc.bneck_fusable(tm.layer2[0])        # stride 2
    assert tm.layer4[1].conv2.dilation == (2, 2)
    assert not trc.bneck_fusable(tm.layer4[1])        # dilation 2
    tm.eval()
    assert tm._bneck_eval_active(tm.layer1[0]) is False   # autograd on
    with torch.no_grad():
        assert tm._bneck_eval_active(tm.layer1[0])
        assert not tm._bneck_eval_active(tm.layer2[0])
    calls = _count_calls(monkeypatch)
    before = trc.run_bneck_eval.launches
    x = torch.randn(2, 3, 33, 33, generator=torch.Generator().manual_seed(1))
    tm(x)                                              # autograd on
    with torch.no_grad():
        tm.train()(x)                                  # train mode
    assert calls == [] and trc.run_bneck_eval.launches == before
    with torch.no_grad(), pytest.raises(ValueError):
        trc.run_bneck_eval(torch.zeros(1, 9, 9, 512), tm.layer2[0])
    tm.eval()
    with pytest.raises(RuntimeError, match="forward-only"):
        trc.run_bneck_eval(torch.zeros(1, 9, 9, 64), tm.layer1[0])


def test_running_stat_update_invalidates_the_fold():
    from kd_cheap_conv_tpu_torch.models.resnet import resnet50

    blk = resnet50().layer1[1].eval()
    x = torch.randn(1, 5, 7, 256, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        a = trc.run_bneck_eval(x, blk)
        folded = trc.fold_bneck_eval(blk, torch.float32)
        assert trc.fold_bneck_eval(blk, torch.float32) is folded
        blk.bn2.running_var.mul_(4.0)
        assert trc.fold_bneck_eval(blk, torch.float32) is not folded
        b = trc.run_bneck_eval(x, blk)
        want = blk(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert not torch.allclose(a, b)
    np.testing.assert_allclose(b.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# (c) the whole ResNet-50
# ---------------------------------------------------------------------------

def test_resnet50_eval_takes_the_bottleneck_kernel_and_matches_jax(
        monkeypatch):
    import jax
    import jax.numpy as jnp
    from flax import nnx
    from jax.sharding import Mesh

    from kd_cheap_conv_tpu import config

    jm, tm = _pair()
    x = np.random.RandomState(3).randn(8, 33, 33, 3).astype(np.float32)
    graphdef, st = nnx.split(jm)
    monkeypatch.setattr(config, "use_pallas_resnet_eval", True)
    config.set_active_mesh(Mesh(np.asarray(jax.devices()), ("data",)))
    try:
        want = jax.jit(lambda st, x: nnx.merge(graphdef, st)(x))(
            st, jnp.asarray(x))
    finally:
        config.set_active_mesh(None)
    calls = _count_calls(monkeypatch)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(calls) == 6
    for k in ("low_level", "out"):
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[k]), rtol=5e-4, atol=5e-4,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# (d) the bf16 kernel's plan (csrc/rchain_eval.cu bnk) by hand at the six
# blocks of the config-#2 teacher (16 x 513², OS16): the tile th x tw, the
# phase-3 pass (128 channels) and the shared memory
# ---------------------------------------------------------------------------

# hw = tw + 2 and hp = (th + 2) hw = 168 at both tiles: h1 192 rows (hp
# padded to 64; a tap of the second computed block reads up to row 127 + 2
# hw + 2), 16 bytes a row at each channel group (8 at Cm 64: 24576 bytes;
# 16 at Cm 128: 49152), the f32 biases (b1, b2 padded to 64 / 128, b3, bd
# to 2 / 4 passes of 128: 2560 / 5120 bytes), an A region of 192 x 128 =
# 24576 bytes a stage, 16 of mbarriers a stage, 16 more and 1024 of slack. layer1's weights are
# resident: W1 (C / 64 boxes of 64 x 64), W2 (9 of them), W3 (2 passes of
# 128 x 64) and layer1.0's Wd (2 more) in 8192 / 16384-byte boxes, 147456
# bytes at C 64 with the downsample, 139264 at C 256, beside 2 stages.
# layer2's 557 KB of weights stream: 3 stages of 24576 + 256 x 128 bytes.
# At 129²: 6 x 19 tiles (22 x 7 an image, 126 computed rows); at 65²: 5 x
# 22 (13 x 3, 120 rows).
@pytest.mark.parametrize("block,geo,want", [
    ("layer1.0", (129, 129, 64, 64, 256, 1),
     (6, 19, 128, 1024 + 147456 + 24576 + 2560 + 2 * 24592 + 16)),
    ("layer1.1", (129, 129, 256, 64, 256, 0),
     (6, 19, 128, 1024 + 139264 + 24576 + 2560 + 2 * 24592 + 16)),
    ("layer1.2", (129, 129, 256, 64, 256, 0),
     (6, 19, 128, 1024 + 139264 + 24576 + 2560 + 2 * 24592 + 16)),
    ("layer2.1", (65, 65, 512, 128, 512, 0),
     (5, 22, 128, 1024 + 49152 + 5120 + 3 * 57360 + 16)),
    ("layer2.2", (65, 65, 512, 128, 512, 0),
     (5, 22, 128, 1024 + 49152 + 5120 + 3 * 57360 + 16)),
    ("layer2.3", (65, 65, 512, 128, 512, 0),
     (5, 22, 128, 1024 + 49152 + 5120 + 3 * 57360 + 16)),
])
def test_bf16_plan_by_hand(block, geo, want):
    assert trc.plan(*geo, 2) == want
    resident = block.startswith("layer1")
    assert trc.bf16_layout(want[0], want[1], *geo[2:]) == (
        resident, 2 if resident else 3, want[3])


def test_guard_takes_cm_up_to_128():
    from kd_cheap_conv_tpu_torch.models.resnet import Bottleneck

    assert trc.bneck_fusable(Bottleneck(512, 128))        # layer2's Cm
    assert not trc.bneck_fusable(Bottleneck(1024, 256))   # layer3's
    with pytest.raises(ValueError, match="Cm up to 128"):
        trc.plan_bf16(33, 33, 1024, 256, 1024, 0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_resnet50(seed):
    from kd_cheap_conv_tpu_torch.models.resnet import resnet50

    g = torch.Generator().manual_seed(seed)
    m = resnet50(output_stride=16)
    for bn in m.modules():
        if isinstance(bn, torch.nn.BatchNorm2d):
            c = bn.num_features
            bn.running_mean = 0.3 * torch.randn(c, generator=g)
            bn.running_var = 1 + 0.5 * torch.rand(c, generator=g)
            bn.weight.data = 1 + 0.2 * torch.randn(c, generator=g)
            bn.bias.data = 0.2 * torch.randn(c, generator=g)
    return m.cuda().eval()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage,shape", [("layer1", (2, 33, 33, 64)),
                                         ("layer1", (3, 17, 29, 64)),
                                         ("layer1", (16, 129, 129, 64)),
                                         ("layer2", (2, 17, 17, 512)),
                                         ("layer2", (1, 9, 5, 512)),
                                         ("layer2", (16, 65, 65, 512))])
def test_bneck_kernel_matches_plain_on_card(cuda, stage, shape, dtype):
    m = _card_resnet50(5)
    g = torch.Generator(cuda).manual_seed(6)
    x = torch.relu(torch.randn(shape, device=cuda, generator=g)).to(dtype)
    tol = 1e-4 if dtype == torch.float32 else BF16_TOL
    before = trc.run_bneck_eval.launches
    with torch.no_grad():
        for blk in _stage(m, stage):
            got, again = trc.run_bneck_eval(x, blk), trc.run_bneck_eval(x, blk)
            want = trc.bneck_eval_ref(x, blk)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            assert err <= tol * float(want.float().abs().max()), err
            assert torch.equal(got, again)
            x = got
    assert trc.run_bneck_eval.launches == before + 2 * len(_stage(m, stage))


@pytest.mark.gpu
def test_resnet50_on_card_matches_module_path(cuda):
    m = _card_resnet50(7)
    ref = copy.deepcopy(m)
    x = torch.randn(2, 3, 65, 65, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(8))
    x = x.contiguous(memory_format=torch.channels_last)
    before = trc.run_bneck_eval.launches
    with torch.no_grad():
        got = m(x)
    want = ref(x)                       # autograd on: the module path
    assert trc.run_bneck_eval.launches == before + 6
    for k in ("low_level", "out"):
        err = float((got[k] - want[k]).abs().max())
        assert err <= 1e-4 * float(want[k].abs().max()), (k, err)


@pytest.mark.gpu
def test_bneck_kernel_refuses_another_layout(cuda):
    from kd_cheap_conv_tpu_torch import native
    from kd_cheap_conv_tpu_torch.ops.stem import _stream

    blk = _card_resnet50(9).layer2[1]
    x = torch.zeros(1, 9, 9, 512, device=cuda, dtype=torch.bfloat16)
    p = trc.fold_bneck_eval(blk, x.dtype)
    y = torch.empty_like(x)
    th, tw, nc, smem = trc.plan(9, 9, 512, 128, 512, 0, 2)
    for bad in ((th, tw, nc, smem + 16), (th, tw, 256, smem),
                (th, 63, nc, smem)):
        err = native.library().kdcc_bneck_eval(
            1, x.data_ptr(), p.w1.data_ptr(), p.b1.data_ptr(), p.w2.data_ptr(),
            p.b2.data_ptr(), p.w3.data_ptr(), p.b3.data_ptr(), None, None,
            y.data_ptr(), 1, 9, 9, 512, 128, 512, *bad, _stream(x))
        assert err != 0, bad
