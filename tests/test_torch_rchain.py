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
                                         ("layer2", (2, 17, 17, 512)),
                                         ("layer2", (1, 9, 5, 512))])
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
