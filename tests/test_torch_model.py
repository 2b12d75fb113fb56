"""The port's cheap-conv student against the JAX package's.

`deeplabv3plus_mobilenet` with its head separable-converted by
`replace_cheap_convs(scope="classifier")`, random BN statistics, eval mode:
the JAX model on its stock path and the port (whose backbone goes through
the eval IR wrappers, which take their plain versions on CPU tensors) give
the same logits within rtol = atol = 1e-4 in f32 at OS8 and OS16, odd and
even sizes. Also: the converter is strict and maps every leaf, and the
synthetic data is byte-for-byte the JAX package's.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import nnx

from kd_cheap_conv_tpu.data.synthetic import \
    SyntheticSegmentation as JaxSynthetic
from kd_cheap_conv_tpu.kd.replace import CheapConvSpec as JaxSpec
from kd_cheap_conv_tpu.kd.replace import \
    replace_cheap_convs as jax_replace_cheap_convs
from kd_cheap_conv_tpu.models import build_model as jax_build_model
from kd_cheap_conv_tpu_torch.convert import state_dict_from_jax
from kd_cheap_conv_tpu_torch.data import SyntheticSegmentation
from kd_cheap_conv_tpu_torch.kd import (AtrousSeparableConvolution,
                                        CheapConvSpec, replace_cheap_convs)
from kd_cheap_conv_tpu_torch.models import build_model

torch.set_num_threads(1)

MODEL = "deeplabv3plus_mobilenet"
TOL = dict(rtol=1e-4, atol=1e-4)


def jax_leaves(module) -> dict:
    flat = nnx.to_flat_state(nnx.state(module, nnx.Any(nnx.Param,
                                                       nnx.BatchStat)))
    return {".".join(map(str, p)): np.asarray(v[...]) for p, v in flat}


@functools.cache
def student_pair(num_classes, output_stride, seed=0):
    """(JAX student, port student) with the same weights, both in eval.
    Shared between tests: do not modify them."""
    jm = jax_build_model(MODEL, num_classes, output_stride,
                         rngs=nnx.Rngs(seed))
    jax_replace_cheap_convs(jm, JaxSpec(), scope="classifier",
                            rngs=nnx.Rngs(seed))
    rng = np.random.RandomState(seed + 1)
    for _, m in nnx.iter_modules(jm):
        if isinstance(m, nnx.BatchNorm):
            c = m.mean[...].shape[0]
            m.scale[...] = jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)
            m.bias[...] = jnp.asarray(0.1 * rng.randn(c), jnp.float32)
            m.mean[...] = jnp.asarray(0.1 * rng.randn(c), jnp.float32)
            m.var[...] = jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)
    jm.eval()
    tm = build_model(MODEL, num_classes, output_stride)
    replace_cheap_convs(tm, scope="classifier")
    tm.load_state_dict(state_dict_from_jax(jax_leaves(jm)), strict=True)
    return jm, tm.to(memory_format=torch.channels_last).eval()


def nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def jax_forward(model, x_nhwc: np.ndarray) -> np.ndarray:
    """The JAX model's NHWC logits, jitted (one compile per shape is faster
    on the CPU than dispatching the model op by op)."""
    graphdef, state = nnx.split(model)
    fn = jax.jit(lambda st, x: nnx.merge(graphdef, st)(x))
    return np.asarray(fn(state, jnp.asarray(x_nhwc)))


@pytest.mark.parametrize("kind,kw", [
    ("ConvBNReLU", dict(stride=2, padding=2, dilation=2)),
    ("ConvBNReLU", dict(padding=1, groups=4, relu=False)),
    ("SeparableConv2d", dict(padding=1, use_bias=True)),
    ("SeparableConv2d", dict(stride=2, dilation=2, bn_between=True,
                             fixed_pad=True))])
def test_layers_match_jax(kind, kw):
    """The shared building blocks, eval mode with random BN statistics."""
    from kd_cheap_conv_tpu.models import layers as jax_layers
    from kd_cheap_conv_tpu_torch.models import layers

    jl = getattr(jax_layers, kind)(8, 12, 3, rngs=nnx.Rngs(0), **kw)
    rng = np.random.RandomState(4)
    for _, m in nnx.iter_modules(jl):
        if isinstance(m, nnx.BatchNorm):
            c = m.mean[...].shape[0]
            m.scale[...] = jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)
            m.mean[...] = jnp.asarray(0.3 * rng.randn(c), jnp.float32)
            m.var[...] = jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)
    jl.eval()
    tl = getattr(layers, kind)(8, 12, 3, **kw)
    tl.load_state_dict(state_dict_from_jax(jax_leaves(jl)), strict=True)
    x = rng.randn(2, 11, 11, 8).astype(np.float32)
    with torch.no_grad():
        got = tl.eval()(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jl(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("output_stride,hw", [(16, 33), (16, 65), (8, 33),
                                              (8, 64)])
def test_student_logits_match_jax(output_stride, hw):
    jm, tm = student_pair(6, output_stride)
    x = np.random.RandomState(hw).randn(2, hw, hw, 3).astype(np.float32)
    want = jax_forward(jm, x)                                 # NHWC
    with torch.no_grad():
        got = tm(nchw(x))                                     # NCHW
        got_cm = tm(nchw(x), class_major=True)
    assert got.shape == (2, 6, hw, hw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
    np.testing.assert_allclose(got_cm.numpy(), got.numpy(), **TOL)


def test_eval_dispatch_matches_module_path():
    """Eval without autograd goes through the IR wrappers; with autograd it
    runs every block's own module. Both give the same features."""
    _, tm = student_pair(6, 16)
    x = nchw(np.random.RandomState(1).randn(1, 33, 33, 3).astype(np.float32))
    with torch.no_grad():
        fused = tm.backbone(x)
    plain = tm.backbone(x)
    for k in ("low_level", "out"):
        np.testing.assert_allclose(fused[k].numpy(), plain[k].detach().numpy(),
                                   **TOL)
    assert fused["low_level"].shape == (1, 24, 9, 9)


def test_replace_scope_matches_jax():
    jm = jax_build_model(MODEL, 6, 16, rngs=nnx.Rngs(0))
    jpaths = jax_replace_cheap_convs(jm, JaxSpec(), scope="classifier",
                                     rngs=nnx.Rngs(0))
    tm = build_model(MODEL, 6, 16)
    paths = replace_cheap_convs(tm, scope="classifier")
    assert sorted(paths) == sorted(jpaths) == [
        "classifier.aspp.branch2.conv", "classifier.aspp.branch3.conv",
        "classifier.aspp.branch4.conv", "classifier.fuse.conv"]
    assert all(isinstance(tm.get_submodule(p), AtrousSeparableConvolution)
               for p in paths)


@pytest.mark.parametrize("kind", ["separable", "grouped"])
def test_factorize_init_matches_jax(kind):
    """Factorizing a dense kernel (per-channel SVD for separable, the
    block-diagonal slice for grouped) gives the same cheap-conv weights in
    both packages."""
    jm = jax_build_model(MODEL, 6, 16, rngs=nnx.Rngs(3))
    leaves = jax_leaves(jm)
    tm = build_model(MODEL, 6, 16)
    tm.load_state_dict(state_dict_from_jax(leaves), strict=True)
    jax_replace_cheap_convs(jm, JaxSpec(kind=kind), scope="classifier",
                            rngs=nnx.Rngs(0))
    replace_cheap_convs(tm, CheapConvSpec(kind=kind), scope="classifier")
    want = state_dict_from_jax(jax_leaves(jm))
    got = tm.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_converter_is_strict_and_complete():
    jm, tm = student_pair(6, 16)
    leaves = jax_leaves(jm)
    sd = state_dict_from_jax(leaves)
    assert set(sd) == set(tm.state_dict())
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in tm.modules())
    assert len(sd) == len(leaves) + n_bn        # + num_batches_tracked
    k = "backbone.features.0.conv.kernel"
    np.testing.assert_array_equal(
        sd["backbone.features.0.conv.weight"].numpy(),
        leaves[k].transpose(3, 2, 0, 1))
    with pytest.raises(KeyError, match="unmapped"):
        state_dict_from_jax({**leaves, "backbone.features.0.conv.rngs": 0})
    with pytest.raises(ValueError, match="HWIO"):
        state_dict_from_jax({k: leaves[k][0]})


@pytest.mark.parametrize("size,idx", [(33, 0), (64, 5), (65, 31)])
def test_synthetic_matches_jax_bytes(size, idx):
    want = JaxSynthetic(6, size=size, length=32, seed=2)[idx]
    got = SyntheticSegmentation(6, size=size, length=32, seed=2)[idx]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
