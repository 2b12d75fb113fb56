"""The port's image-entry kernels against the JAX package's: the student's
entry conv inside the stem chain (ops.stem `run_f0`, `run_f0_wgrad`,
`run_f0_xgrad`, `fused_stem_f1f2` in f0 mode) and the teacher's fused eval
stem + maxpool (ops.tstem). The JAX kernels run in interpret mode on the
CPU, on the host-packed image (`s2d_pack(x, channel_sublane=True)`) they
read; the port's read the image itself.

- (a) The three plain f0 functions against `_run_f0` and `_run_f0_bwd` at
  2x17², f32: a0 rtol = atol = 1e-4, moments and dW0 rtol 1e-4 / atol 1e-5,
  the image gradient rtol 1e-4 / atol 1e-5. The JAX dW0 (the hcat-packed
  (48, 32) transpose) and packed-image gradient map back through the VJPs
  of their (linear) packings.
- (b) `fused_stem_f1f2` in f0 mode against the JAX one in f0 mode, 2x17²:
  values 1e-4, stats 1e-4/1e-5, gradients rtol 2e-3 with atol 2e-4 for the
  image (through a differentiable `s2d_pack`) and 2e-3 for w0 and every
  parameter (tests/test_pallas_stem.py's tolerances).
- (c) Sizes the JAX f0 does not take (1x16², 1x16x19): the f0 chain
  against the port's a0-mode chain fed `F.conv2d`'s output, the image
  gradient against autograd through `F.conv2d`.
- (d) `fused_stem_pool_eval_ref` against `fused_stem_pool_eval_nhcw`
  (interpret) at 2x33², f32, rtol = atol = 1e-4, and against the module
  path (conv + eval BN + relu + max_pool2d) at even and odd sizes.
- (e) The port's ResNet-50 eval forward under no_grad, which takes the
  fused stem, against the JAX one with KDCC_TSTEM forced on and the packed
  input, at 33²: both feature taps rtol = atol = 5e-4 (the JAX test's).
  The port's layer1 and layer2[1:] also take the eval bottleneck's plain
  version; the JAX side keeps its bottlenecks stock here
  (tests/test_torch_rchain.py holds them to its bottleneck kernels).

- (f) The bf16 stem kernel's operands and plan (ops/tstem.py mirrors of
  csrc/entry_convs.cu `tsm::`): the fragment-layout weight read back by
  mma.m16n8k16's rule is the space-to-depth weight, each folded weight
  once and zeros elsewhere; the space-to-depth product is the strided conv
  (f64, 1e-12); the shared-memory layout and two CTAs an SM; the tiles
  cover each pooled output once, split evenly.

The `gpu` cases compare each CUDA kernel with its plain version on the card
(the bf16 stem also with an f64 run of its operands, to one bf16 ulp plus
the f32 sum's error bound, at partial tiles and at more tiles than CTAs)
and skip where there is none.
"""

import copy
import functools
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kd_cheap_conv_tpu_torch.ops import stem as tst
from kd_cheap_conv_tpu_torch.ops import tstem as tts
from test_torch_stem import _bnbwd, _jax_in, _jax_out, _stem_params, _t

torch.set_num_threads(1)

EPS = 1e-5
VAL = dict(rtol=1e-4, atol=1e-4)
SUM = dict(rtol=1e-4, atol=1e-5)


def _f0_data(n=2, hw=17, seed=0):
    rng = np.random.RandomState(seed)
    ho = (hw + 1) // 2
    return {"x": rng.randn(n, hw, hw, 3).astype(np.float32),
            "w0": (0.3 * rng.randn(3, 3, 3, 32)).astype(np.float32),  # HWIO
            "gy": rng.randn(n, ho, ho, 32).astype(np.float32),
            "a0": rng.randn(n, ho, ho, 32).astype(np.float32),
            "pn": _bnbwd(rng, 32, n * ho * ho)}


def _oihw(w_hwio):
    return _t(np.transpose(w_hwio, (3, 2, 0, 1)))


def _w0_param(w):
    """(3, 3, 3, C0) HWIO entry kernel -> the JAX (C0, 48) hcat-packed f0
    param (tests/test_pallas_stem.py's `_w0_param`)."""
    import jax.numpy as jnp

    co = w.shape[3]
    w2 = jnp.pad(w, ((0, 1), (0, 1), (0, 0), (0, 0)))
    w2 = jnp.transpose(w2.reshape(2, 2, 2, 2, 3, co),
                       (0, 2, 1, 3, 4, 5)).reshape(4, 12, co)
    return jnp.transpose(w2, (2, 0, 1)).reshape(co, 48)


def _pack(x):
    from kd_cheap_conv_tpu.ops.conv import s2d_pack

    return s2d_pack(x, channel_sublane=True)


# ---------------------------------------------------------------------------
# (a) the three f0 functions
# ---------------------------------------------------------------------------

@functools.cache
def _jax_f0():
    """(a0, mean, var, dW0 HWIO, dx) of `_run_f0` / `_run_f0_bwd`."""
    import jax
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas import stem as js

    d = _f0_data()
    x = jnp.asarray(d["x"])
    n, hw = x.shape[0], x.shape[1]
    h = (hw + 1) // 2
    nh, _, _, rows, _ = js._geom(h)
    xpk = _pack(x)                                   # (N, H + 3, 12, W + 3)
    hp, wr = xpk.shape[1], xpk.shape[3]
    wp = js._lanes(h)
    vp = jnp.pad(xpk, ((0, 0), (0, nh * js.BH + 2 - hp), (0, 0),
                       (0, wp - wr)))
    w0 = _w0_param(jnp.asarray(d["w0"]))
    a0p, m, v = js._run_f0(vp, w0, h, h, rows, True, jnp.float32)
    c0 = w0.shape[0]
    w0g = jnp.transpose(w0.reshape(c0, 4, 12), (2, 1, 0)).reshape(12, 4 * c0)
    dw0t, gv = js._run_f0_bwd(_jax_in(d["gy"], rows), _jax_in(d["a0"], rows),
                              vp, jnp.asarray(d["pn"]), w0g, h, h, EPS, True,
                              jnp.float32)
    _, w_vjp = jax.vjp(_w0_param, jnp.asarray(d["w0"]))
    (dw_hwio,) = w_vjp(jnp.transpose(dw0t))
    _, x_vjp = jax.vjp(_pack, x)
    (dx,) = x_vjp(gv[:, :hp, :, :wr])
    return (_jax_out(a0p, h, h), np.asarray(m), np.asarray(v),
            np.asarray(dw_hwio), np.asarray(dx))


@pytest.mark.parametrize("what", ["forward", "wgrad", "xgrad"])
def test_plain_f0_matches_jax_runner(what):
    d = _f0_data()
    want = _jax_f0()
    x, w0 = _t(d["x"]), _oihw(d["w0"])
    if what == "forward":
        a0, m, v = tst.run_f0(x, w0)
        assert a0.shape == want[0].shape
        np.testing.assert_allclose(a0.numpy(), want[0], **VAL)
        np.testing.assert_allclose(m.numpy(), want[1], err_msg="mean", **SUM)
        np.testing.assert_allclose(v.numpy(), want[2], err_msg="var", **SUM)
    elif what == "wgrad":
        dw = tst.run_f0_wgrad(_t(d["gy"]), _t(d["a0"]), x, _t(d["pn"]), EPS)
        np.testing.assert_allclose(dw.numpy(), _oihw(want[3]).numpy(),
                                   **SUM)
    else:
        dx = tst.run_f0_xgrad(_t(d["gy"]), _t(d["a0"]), _t(d["pn"]), w0,
                              x.shape, EPS)
        assert dx.shape == x.shape
        np.testing.assert_allclose(dx.numpy(), want[4], **SUM)


# ---------------------------------------------------------------------------
# (b) the f0 chain against the JAX one, (c) at sizes the JAX f0 does not take
# ---------------------------------------------------------------------------

def _chain_data():
    rng = np.random.RandomState(11)
    x = rng.randn(2, 17, 17, 3).astype(np.float32)
    w0 = (0.3 * rng.randn(3, 3, 3, 32)).astype(np.float32)
    cot = rng.randn(2, 5, 5, 24).astype(np.float32)
    return x, w0, cot, _stem_params()


@functools.cache
def _jax_f0_chain():
    """(out, stats, loss, d image, d w0 HWIO, d params) of the JAX chain in
    f0 mode, from the packed image (a differentiable jnp s2d_pack)."""
    import jax
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas.stem import fused_stem_f1f2

    x, w0, cot, p = _chain_data()
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def run(x, w0, p):
        return fused_stem_f1f2(_pack(x), {**p, "w0": _w0_param(w0)}, EPS,
                               True)

    def loss(x, w0, p):
        out, _ = run(x, w0, p)
        return jnp.sum(out.astype(jnp.float32) * cot)

    args = (jnp.asarray(x), jnp.asarray(w0), jp)
    out, stats = run(*args)
    val, (gx, gw, gp) = jax.value_and_grad(loss, argnums=(0, 1, 2))(*args)
    return (np.asarray(out), [(np.asarray(m), np.asarray(v))
                              for m, v in stats], float(val), np.asarray(gx),
            np.asarray(gw), {k: np.asarray(v) for k, v in gp.items()})


def test_f0_chain_matches_jax():
    x, w0, cot, p = _chain_data()
    want_out, want_stats, want_val, want_gx, want_gw, want_gp = \
        _jax_f0_chain()
    tx = _t(x).requires_grad_()
    tw = _oihw(w0).requires_grad_()
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    out, stats = tst.fused_stem_f1f2(tx, {**tp, "w0": tw}, EPS)
    assert out.shape == want_out.shape == (2, 5, 5, 24)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **VAL)
    assert len(stats) == 6
    for k, ((m, v), (wm, wv)) in enumerate(zip(stats, want_stats)):
        np.testing.assert_allclose(m.numpy(), wm, err_msg=f"mean{k}", **SUM)
        np.testing.assert_allclose(v.numpy(), wv, err_msg=f"var{k}", **SUM)
    loss = (out * _t(cot)).sum()
    np.testing.assert_allclose(float(loss.detach()), want_val, rtol=1e-4)
    loss.backward()
    np.testing.assert_allclose(tx.grad.numpy(), want_gx, rtol=2e-3,
                               atol=2e-4, err_msg="d image")
    np.testing.assert_allclose(tw.grad.numpy(), _oihw(want_gw).numpy(),
                               rtol=2e-3, atol=2e-3, err_msg="d w0")
    for k in sorted(tp):
        np.testing.assert_allclose(tp[k].grad.numpy(), want_gp[k], rtol=2e-3,
                                   atol=2e-3, err_msg=f"d {k}")


@pytest.mark.parametrize("shape", [(1, 16, 16), (1, 16, 19)])
def test_f0_chain_matches_a0_chain_on_conv2d(shape):
    """features[0..2] from the image against the a0-mode chain fed
    F.conv2d's output, values, statistics and every gradient, at even and
    mixed sizes (the JAX f0 takes odd sizes only)."""
    rng = np.random.RandomState(5)
    x = _t(rng.randn(*shape, 3))
    w0 = _t(0.3 * rng.randn(32, 3, 3, 3))
    p = {k: _t(v) for k, v in _stem_params(3).items()}
    outs = []
    for f0_mode in (True, False):
        tx, tw = x.clone().requires_grad_(), w0.clone().requires_grad_()
        tp = {k: v.clone().requires_grad_() for k, v in p.items()}
        if f0_mode:
            out, stats = tst.fused_stem_f1f2(tx, {**tp, "w0": tw}, EPS)
        else:
            a0 = F.conv2d(tx.permute(0, 3, 1, 2), tw, None, 2, 1)
            out, stats = tst.fused_stem_f1f2(a0.permute(0, 2, 3, 1), tp, EPS)
        cot = torch.from_numpy(np.random.RandomState(6).randn(
            *out.shape).astype(np.float32))
        (out * cot).sum().backward()
        outs.append((out.detach(), stats, tx.grad, tw.grad,
                     {k: v.grad for k, v in tp.items()}))
    (o1, s1, gx1, gw1, gp1), (o2, s2, gx2, gw2, gp2) = outs
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), **VAL)
    for (m, v), (wm, wv) in zip(s1, s2):
        np.testing.assert_allclose(m.numpy(), wm.numpy(), **SUM)
        np.testing.assert_allclose(v.numpy(), wv.numpy(), **SUM)
    np.testing.assert_allclose(gx1.numpy(), gx2.numpy(), rtol=2e-3,
                               atol=2e-4, err_msg="d image")
    np.testing.assert_allclose(gw1.numpy(), gw2.numpy(), rtol=2e-3,
                               atol=2e-3, err_msg="d w0")
    for k in gp1:
        np.testing.assert_allclose(gp1[k].numpy(), gp2[k].numpy(), rtol=2e-3,
                                   atol=2e-3, err_msg=f"d {k}")


# ---------------------------------------------------------------------------
# (d) the teacher stem, (e) in the ResNet
# ---------------------------------------------------------------------------

def _stem_modules(seed=0):
    """The port's ResNet stem conv and BN with random eval statistics."""
    from kd_cheap_conv_tpu_torch.models.layers import ConvBNReLU

    g = torch.Generator().manual_seed(seed)
    stem = ConvBNReLU(3, 64, 7, stride=2, padding=3, generator=g)
    bn = stem.bn
    bn.weight.data = 1 + 0.2 * torch.randn(64, generator=g)
    bn.bias.data = 0.2 * torch.randn(64, generator=g)
    bn.running_mean = 0.3 * torch.randn(64, generator=g)
    bn.running_var = 1 + 0.5 * torch.rand(64, generator=g)
    return stem.eval()


def test_tstem_ref_matches_jax_kernel():
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas.tstem import fused_stem_pool_eval_nhcw

    stem = _stem_modules()
    x = np.random.RandomState(17).randn(2, 33, 33, 3).astype(np.float32)
    bn = stem.bn
    jbn = types.SimpleNamespace(
        scale=jnp.asarray(bn.weight.detach().numpy()),
        bias=jnp.asarray(bn.bias.detach().numpy()),
        mean=jnp.asarray(bn.running_mean.numpy()),
        var=jnp.asarray(bn.running_var.numpy()), epsilon=bn.eps)
    kernel = jnp.asarray(stem.conv.weight.detach().numpy().transpose(2, 3, 1,
                                                                     0))
    want = fused_stem_pool_eval_nhcw(jnp.asarray(_pack(x)), kernel, jbn,
                                     interpret=True)
    with torch.no_grad():
        got = tts.fused_stem_pool_eval(_t(x), stem.conv, bn)
    assert got.shape == want.shape == (2, 9, 9, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)


@pytest.mark.parametrize("hw", [(32, 32), (33, 30), (8, 9)])
def test_tstem_ref_matches_module_path(hw):
    stem = _stem_modules(1)
    x = torch.randn(2, 3, *hw, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = F.max_pool2d(stem(x), 3, 2, 1)
        got = tts.fused_stem_pool_eval(x.permute(0, 2, 3, 1).contiguous(),
                                       stem.conv, stem.bn)
    assert got.shape == want.permute(0, 2, 3, 1).shape
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               **VAL)


def test_tstem_refuses_autograd_and_other_stems():
    stem = _stem_modules()
    x = torch.zeros(1, 9, 9, 3)
    with pytest.raises(RuntimeError, match="forward-only"):
        tts.fused_stem_pool_eval(x, stem.conv, stem.bn)
    stem.conv.padding = (2, 2)
    with torch.no_grad(), pytest.raises(ValueError):
        tts.fused_stem_pool_eval(x, stem.conv, stem.bn)


# ---------------------------------------------------------------------------
# (f) the bf16 stem kernel's operands and plan, mirrored in ops/tstem.py
# ---------------------------------------------------------------------------

def _s2d_weight(w):
    """The folded (64, 147) weight as the s2d GEMM's B^T (64, 256), built
    by padding and reshaping: k = (dR * 4 + dC) * 16 + a * 6 + b * 3 + ci
    for image tap (2 dR + a, 2 dC + b), zero where dh or dw is 7 and in
    channels 12..15."""
    w8 = F.pad(w.reshape(64, 7, 7, 3), (0, 0, 0, 1, 0, 1))
    w8 = w8.reshape(64, 4, 2, 4, 2, 3).permute(0, 1, 3, 2, 4, 5)
    return F.pad(w8.reshape(64, 16, 12), (0, 4)).reshape(64, 256)


def _bt_from_frag(frag):
    """B^T (64, 256) read back from the fragment layout by PTX
    mma.m16n8k16's rule: b0 = Bt[g][2t..2t+1], b1 = Bt[g][2t+8..2t+9] of
    n8 block j, lane = 4 g + t; two blocks a 16-byte lane slot."""
    f = frag.reshape(16, 4, 32, 2, 2, 2)         # tap, pair, lane, j, b0/b1, e
    bt = torch.empty(64, 256, dtype=frag.dtype)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for jp in range(4):
            for j in range(2):
                n = 8 * (2 * jp + j) + g
                for half in range(2):
                    k = torch.arange(16) * 16 + 2 * t + 8 * half
                    bt[n, k] = f[:, jp, lane, j, half, 0]
                    bt[n, k + 1] = f[:, jp, lane, j, half, 1]
    return bt


def test_tstem_fragments_are_the_fold_permuted_and_zero_padded():
    stem = _stem_modules(3)
    w, _ = tts.fold_stem(stem.conv, stem.bn, torch.bfloat16)
    frag = tts.stem_frag(w)
    assert frag.shape == (tts.FRAG_VALUES,) and frag.dtype == torch.bfloat16
    # every folded weight exactly once, zeros elsewhere
    nz = frag[frag != 0]
    assert nz.numel() == w.numel()
    assert torch.equal(nz.float().sort().values,
                       w.reshape(-1).float().sort().values)
    # and in the place the tensor cores read it from
    assert torch.equal(_bt_from_frag(frag), _s2d_weight(w))


def test_tstem_s2d_product_is_the_strided_conv():
    """The kernel's GEMM (s2d image shifted by rows 3, columns 3; 16 taps of
    16 channels against `_bt_from_frag`) is the 7x7 / stride 2 / pad 3
    conv, in f64."""
    rng = np.random.RandomState(9)
    w = torch.from_numpy(rng.randn(64, 147))
    x = torch.from_numpy(rng.randn(2, 21, 18, 3))
    bt = _bt_from_frag(tts.stem_frag(w))
    n, h, wd, _ = x.shape
    hc, wc = (h + 1) // 2, (wd + 1) // 2
    xp = F.pad(x, (0, 0, 3, 2 * (wc + 3) - wd - 3, 3, 2 * (hc + 3) - h - 3))
    s2d = xp.reshape(n, hc + 3, 2, wc + 3, 2, 3).permute(0, 1, 3, 2, 4, 5)
    s2d = F.pad(s2d.reshape(n, hc + 3, wc + 3, 12), (0, 4))
    got = sum(s2d[:, dr:dr + hc, dc:dc + wc] @ bt[:, 16 * (4 * dr + dc):][:, :16].t()
              for dr in range(4) for dc in range(4))
    want = F.conv2d(x.permute(0, 3, 1, 2),
                    w.reshape(64, 7, 7, 3).permute(0, 3, 1, 2), None, 2, 3)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_tstem_bf16_shared_memory_mirror():
    """bf16_smem_bytes is the kernel's layout (tsm::kSmem, which the .cu
    asserts): fragment weights, shift, s2d tile, conv tile, two raw stages;
    two CTAs fit an H100 SM (228 KB, 1 KB reserved a CTA)."""
    parts = [16 * 4 * 32 * 16, 64 * 4, 12 * 36 * 32, 9 * 33 * 64 * 2,
             2 * 24 * 448]
    assert tts.bf16_smem_bytes() == sum(parts) == 106368
    assert 2 * (tts.bf16_smem_bytes() + 1024) <= 228 * 1024


@pytest.mark.parametrize("n,h,w", [(16, 513, 513), (2, 40, 37), (4, 257, 255),
                                   (1, 9, 8), (3, 65, 130)])
def test_tstem_bf16_tiles_cover_each_pooled_output_once(n, h, w):
    ho, wo = ((h + 1) // 2 + 1) // 2, ((w + 1) // 2 + 1) // 2
    tiles = tts.bf16_tiles(n, h, w)
    seen = np.zeros((n, ho, wo), np.int64)
    for img, r0, nr, c0, nc in tiles:
        assert 1 <= nr <= tts.TPH and 1 <= nc <= tts.TPW
        seen[img, r0:r0 + nr, c0:c0 + nc] += 1
    assert (seen == 1).all()
    # the launch's grid: one CTA a tile up to a wave of GRID
    assert len(tiles) == n * -(-ho // tts.TPH) * -(-wo // tts.TPW)
    # rows split evenly: no tile is a sliver of a full one
    assert max(t[2] for t in tiles) - min(t[2] for t in tiles) <= 1
    assert max(t[4] for t in tiles) - min(t[4] for t in tiles) <= 1


@functools.cache
def _resnet_pair():
    """(JAX resnet50 in eval mode, the port's with its weights)."""
    from flax import nnx

    from kd_cheap_conv_tpu.models.resnet import resnet50 as jax_resnet50
    from kd_cheap_conv_tpu_torch.convert import state_dict_from_jax
    from kd_cheap_conv_tpu_torch.models.resnet import resnet50
    from test_torch_model import jax_leaves
    from test_torch_train import _randomize_bn

    jm = nnx.jit(lambda: jax_resnet50(output_stride=16, rngs=nnx.Rngs(0)))()
    _randomize_bn(jm, 8)
    jm.eval()
    tm = resnet50(output_stride=16)
    tm.load_state_dict(state_dict_from_jax(jax_leaves(jm)), strict=True)
    return jm, tm.to(memory_format=torch.channels_last).eval()


def test_resnet50_eval_takes_the_fused_stem_and_matches_jax(monkeypatch):
    import jax
    import jax.numpy as jnp
    from flax import nnx

    from kd_cheap_conv_tpu import config

    jm, tm = _resnet_pair()
    x = np.random.RandomState(3).randn(2, 33, 33, 3).astype(np.float32)
    graphdef, st = nnx.split(jm)
    monkeypatch.setattr(config, "use_pallas_teacher_stem", True)
    monkeypatch.setattr(config, "use_host_s2d", True)
    want = jax.jit(lambda st, x: nnx.merge(graphdef, st)(x))(
        st, jnp.asarray(_pack(x)))
    calls = []
    orig = tts.fused_stem_pool_eval_ref
    monkeypatch.setattr(tts, "fused_stem_pool_eval_ref",
                        lambda *a: calls.append(1) or orig(*a))
    assert tm._fused_stem_eval_active() is False      # autograd on
    with torch.no_grad():
        assert tm._fused_stem_eval_active()
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert calls == [1]
    for k in ("low_level", "out"):
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[k]), rtol=5e-4, atol=5e-4,
                                   err_msg=k)


def test_resnet_train_mode_keeps_the_module_stem(monkeypatch):
    from kd_cheap_conv_tpu_torch.models.resnet import ResNet

    tm = ResNet((1, 1, 1, 1), output_stride=16)
    ref = copy.deepcopy(tm)
    calls = []
    monkeypatch.setattr(tts, "fused_stem_pool_eval_ref",
                        lambda *a: calls.append(1))
    x = torch.randn(2, 3, 33, 33, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = tm.train()(x)["low_level"]
        want = F.max_pool2d(ref.train().stem(x), 3, 2, 1)
        for b in ref.layer1:
            want = b(want)
    assert calls == []
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


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


def _card_f0(dtype, dev, n=2, h=19, w=19, seed=3):
    rng = np.random.RandomState(seed)
    ho, wo = (h + 1) // 2, (w + 1) // 2
    act = {k: _t(rng.randn(*s)).to(dev, dtype) for k, s in (
        ("x", (n, h, w, 3)), ("gy", (n, ho, wo, 32)), ("a0", (n, ho, wo, 32)))}
    pn = torch.from_numpy(_bnbwd(rng, 32, n * ho * wo)).to(dev)
    w0 = _t(0.3 * rng.randn(32, 3, 3, 3)).to(dev)
    return act, pn, w0


def _close(got, want, tol):
    g, w = got.float().cpu(), want.float().cpu()
    err = float((g - w).abs().max())
    assert err <= tol * max(float(w.abs().max()), 1e-6), err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("what", ["forward", "wgrad", "xgrad"])
def test_f0_kernel_matches_plain_on_card(cuda, what, dtype):
    act, pn, w0 = _card_f0(dtype, cuda)
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    fn = {"forward": tst.run_f0, "wgrad": tst.run_f0_wgrad,
          "xgrad": tst.run_f0_xgrad}[what]
    before = fn.launches
    if what == "forward":
        got = fn(act["x"], w0)
        y, sums = tst.f0_ref(act["x"], w0)
        want = (y, *tst._moments(sums, tst._count(y)))
    elif what == "wgrad":
        got = [fn(act["gy"], act["a0"], act["x"], pn)]
        want = [tst.f0_wgrad_ref(act["gy"], act["a0"], act["x"], pn)]
    else:
        got = [fn(act["gy"], act["a0"], pn, w0, act["x"].shape)]
        want = [tst.f0_xgrad_ref(act["gy"], act["a0"], pn, w0,
                                 act["x"].shape)]
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    for g, w in zip(got, want):
        _close(g, w, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(18, 17), (17, 18), (9, 4)])
def test_f0_xgrad_odd_and_even_sizes_on_card(cuda, hw):
    act, pn, w0 = _card_f0(torch.float32, cuda, h=hw[0], w=hw[1])
    got = tst.run_f0_xgrad(act["gy"], act["a0"], pn, w0, act["x"].shape)
    want = tst.f0_xgrad_ref(act["gy"], act["a0"], pn, w0, act["x"].shape)
    torch.cuda.synchronize()
    _close(got, want, 1e-4)


@pytest.mark.gpu
def test_f0_wgrad_is_deterministic(cuda):
    act, pn, _ = _card_f0(torch.bfloat16, cuda, n=4, h=65, w=65)
    a = tst.run_f0_wgrad(act["gy"], act["a0"], act["x"], pn)
    b = tst.run_f0_wgrad(act["gy"], act["a0"], act["x"], pn)
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("needs_grad", [False, True])
def test_f0_xgrad_runs_only_when_the_image_needs_a_gradient(cuda,
                                                            needs_grad):
    act, _, w0 = _card_f0(torch.float32, cuda)
    p = {k: _t(v).to(cuda).requires_grad_()
         for k, v in _stem_params().items()}
    x = act["x"].clone().requires_grad_(needs_grad)
    before = [fn.launches for fn in tst.F0_KERNELS]
    out, _ = tst.fused_stem_f1f2(x, {**p, "w0": w0.requires_grad_()})
    out.float().sum().backward()
    torch.cuda.synchronize()
    got = [fn.launches - b for fn, b in zip(tst.F0_KERNELS, before)]
    assert got == [1, 1, int(needs_grad)]
    assert (x.grad is not None) == needs_grad


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(65, 65), (40, 37)])
def test_tstem_kernel_matches_plain_on_card(cuda, dtype, hw):
    stem = _stem_modules().to(cuda)
    x = torch.randn(2, *hw, 3, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(5)).to(dtype)
    with torch.no_grad():
        before = tts.fused_stem_pool_eval.launches
        got = tts.fused_stem_pool_eval(x, stem.conv, stem.bn)
        want = tts.fused_stem_pool_eval_ref(x, stem.conv, stem.bn)
    torch.cuda.synchronize()
    assert tts.fused_stem_pool_eval.launches == before + 1
    rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 else (5e-2, 1e-1)
    g, w = got.float(), want.float()
    assert bool(((g - w).abs() <= atol + rtol * w.abs()).all())


def _stem_f64(x, stem):
    """The stem in f64 from the bf16 kernel's own operands (image and folded
    weight widened to f64): conv + shift + relu + max pool, NHWC; and, over
    each pool window, the largest sum of |x w| + |shift| (the scale of an
    f32 sum's rounding error)."""
    w, shift = tts.fold_stem(stem.conv, stem.bn, torch.bfloat16)
    wk = w.double().reshape(64, 7, 7, 3).permute(0, 3, 1, 2)
    xc = x.double().permute(0, 3, 1, 2)
    h = torch.relu(F.conv2d(xc, wk, None, 2, 3) + shift.double()[:, None, None])
    s = F.conv2d(xc.abs(), wk.abs(), None, 2, 3) + shift.double().abs()[:, None,
                                                                      None]
    return tuple(F.max_pool2d(t, 3, 2, 1).permute(0, 2, 3, 1) for t in (h, s))


def _ulp_tol(want, scale):
    """One bf16 ulp of each output's own magnitude, plus the bound of the
    f32 sum's own error (148 terms, 2^-23 each of their magnitude: round to
    nearest or the tensor cores' truncation): outputs near zero (relu's
    edge) keep an f32 sum's error, which no f32 kernel avoids."""
    a = want.abs()
    ulp = torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a)) - 7),
                      torch.zeros_like(a))
    return ulp + 148 * 2.0 ** -23 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("n,hw", [((2, (40, 37))), ((4, (257, 255)))])
def test_tstem_bf16_kernel_within_one_ulp_of_f64_on_card(cuda, n, hw):
    """Partial tiles in both axes (40 x 37: pooled 10 x 10), and more tiles
    than the wave's CTAs (4 x 257 x 255: 272 tiles), each output within one
    bf16 ulp of its own magnitude of an f64 run of the same operands (plus
    the f32 sum's error bound, `_ulp_tol`)."""
    stem = _stem_modules(4).to(cuda)
    x = torch.randn(n, *hw, 3, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(6)).to(
                        torch.bfloat16)
    assert len(tts.bf16_tiles(n, *hw)) > tts.GRID or hw == (40, 37)
    with torch.no_grad():
        before = tts.fused_stem_pool_eval.launches
        got = tts.fused_stem_pool_eval(x, stem.conv, stem.bn)
    want, scale = _stem_f64(x, stem)
    torch.cuda.synchronize()
    assert tts.fused_stem_pool_eval.launches == before + 1
    err = (got.double() - want).abs()
    tol = _ulp_tol(want, scale)
    assert bool((err <= tol).all()), (int((err > tol).sum()),
                                      float(want[err > tol].abs().max()))
