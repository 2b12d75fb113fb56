"""The port's train-mode BN-barrier passes, fused stem and fused IR chain
(kd_cheap_conv_tpu_torch.ops.stem / ops.irchain) against the JAX package's,
whose Pallas kernels run in interpret mode on the CPU.

- (a) Each plain pass against its JAX runner (`_run_bn_pw`, `_run_bn_dw`,
  `_run_bn_dw_s2`, `_run_pw_bwd`, `_run_dw_bwd`, `_run_dw_s2_bwd`) at
  2x17x17, f32; the JAX side's padded (N, R, C, Wp) layout is read back
  from rows [PAD, PAD + H) and lanes [0, W). Values rtol = atol = 1e-4;
  moments, sums and dW/dk rtol 1e-4, atol 1e-5. The identity cases hold
  the port's exact identity (None) against the JAX packs, whose backward
  identity scales by rsqrt(1 + eps) = 1 - 5e-6, inside that tolerance.
- (b) `fused_stem_f1f2` (a0 input, no f0-in-chain) and `fused_ir_chain` at
  the JAX tests' shapes, 2x17² and an even 1x16²: values 1e-4, stats
  1e-4/1e-5, gradients of the input and every parameter rtol 2e-3 with
  atol 2e-4 (input) and 2e-3 (parameters), the JAX tests' tolerances.
- (c) The port's MobileNetV2 in train mode against the JAX MobileNetV2 with
  its fused chains and its entry-conv kernels (f0 in the chain, on the
  host-packed image) forced on, 2 images at 33², f32: outputs, gradients
  (with the JAX tests' allowance for isolated relu6 clip-boundary flips)
  and the running statistics of the 18 BNs of features[0..6]; the plain
  passes and entry-conv functions are counted, so the test cannot pass on
  the module path.
- (d) The guards: a backbone-scope cheap-conv surgery, an entry conv with
  padding 0, a conv with a bias inside f2, and eval mode leave the chains
  untaken.

The `gpu` cases compare each CUDA kernel with its plain version on the card
and skip where there is none; JAX is imported inside the JAX-side helpers,
so they run where JAX is not installed.
"""

import copy
import functools

import numpy as np
import pytest
import torch

from kd_cheap_conv_tpu_torch.ops import irchain as tir
from kd_cheap_conv_tpu_torch.ops import stem as tst

torch.set_num_threads(1)

EPS = 1e-5
VAL = dict(rtol=1e-4, atol=1e-4)
SUM = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _bn(rng, c):
    return np.stack([0.1 * rng.randn(c), rng.uniform(0.5, 1.5, c),
                     1 + 0.3 * rng.randn(c), 0.2 * rng.randn(c)],
                    1).astype(np.float32)


def _bnbwd(rng, c, count):
    return np.stack([0.1 * rng.randn(c), rng.uniform(0.5, 1.5, c),
                     1 + 0.3 * rng.randn(c), 5 * rng.randn(c),
                     5 * rng.randn(c), np.full(c, 1.0 / count)],
                    1).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the six passes
# ---------------------------------------------------------------------------

def _jax_in(x, rows):
    """NHWC numpy -> the JAX runners' padded (N, rows, C, lanes) layout."""
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas.stem import PAD, _lanes

    n, h, w, c = x.shape
    z = np.zeros((n, rows, c, _lanes(w)), np.float32)
    z[:, PAD:PAD + h, :, :w] = x.transpose(0, 1, 3, 2)
    return jnp.asarray(z)


def _jax_out(y, h, w):
    from kd_cheap_conv_tpu.ops.pallas.stem import PAD

    return np.asarray(y)[:, PAD:PAD + h, :, :w].transpose(0, 1, 3, 2)


# name: (pass, C_in, C_out, relu, identity)
PASSES = {
    "bn_pw": ("bn_pw", 16, 24, True, False),
    "bn_pw_linear": ("bn_pw", 24, 16, False, False),
    "bn_pw_identity": ("bn_pw", 24, 32, False, True),
    "bn_dw": ("bn_dw", 32, 32, True, False),
    "bn_dw_s2": ("bn_dw_s2", 24, 24, True, False),
    "pw_bwd": ("pw_bwd", 16, 24, True, False),
    "pw_bwd_linear": ("pw_bwd", 24, 16, False, False),
    "pw_bwd_identity": ("pw_bwd", 24, 32, False, True),
    "dw_bwd": ("dw_bwd", 32, 32, True, False),
    "dw_s2_bwd": ("dw_s2_bwd", 24, 24, True, False),
}


def _pass_inputs(name, n=2, hw=17, seed=0):
    kind, ci, co, relu, ident = PASSES[name]
    rng = np.random.RandomState(seed)
    s = 2 if kind in ("bn_dw_s2", "dw_s2_bwd") else 1
    ho = (hw - 1) // s + 1
    d = {"x": rng.randn(n, hw, hw, ci).astype(np.float32),
         "bn": _bn(rng, ci), "relu": relu, "ident": ident, "s": s, "ho": ho}
    if kind in ("bn_pw", "pw_bwd"):
        d["w"] = (0.3 * rng.randn(co, ci)).astype(np.float32)
    else:
        d["k"] = (0.5 * rng.randn(ci, 9)).astype(np.float32)
    if kind.endswith("bwd"):
        d["gy"] = rng.randn(n, ho, ho, co).astype(np.float32)
        d["an"] = rng.randn(n, ho, ho, co).astype(np.float32)
        d["pn"] = _bnbwd(rng, co, n * ho * ho)
    return kind, d


def _port_pass(kind, d):
    bn = None if d["ident"] else _t(d["bn"])
    if kind in ("bn_pw", "bn_dw", "bn_dw_s2"):
        fn = getattr(tst, f"run_{kind}")
        wk = _t(d["w"] if kind == "bn_pw" else d["k"])
        y, m, v = fn(_t(d["x"]), bn, wk, d["relu"], EPS)
        return [y, m, v]
    pn = None if d["ident"] else _t(d["pn"])
    fn = getattr(tst, f"run_{kind}")
    wk = _t(d["w"] if kind == "pw_bwd" else d["k"])
    return list(fn(_t(d["gy"]), _t(d["an"]), _t(d["x"]), pn, bn, wk,
                   d["relu"], EPS))


def _jax_pass(kind, d):
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas import stem as js
    from kd_cheap_conv_tpu.ops.pallas.irchain import _identity_bn_eps

    x = d["x"]
    n, h, w, ci = x.shape
    _, _, _, rows, rows2 = js._geom(h)
    f32 = jnp.float32
    bn = (_identity_bn_eps(ci, EPS) if d["ident"] else jnp.asarray(d["bn"]))
    if kind == "bn_pw":
        y, m, v = js._run_bn_pw(_jax_in(x, rows), bn, jnp.asarray(d["w"]), h,
                                w, d["relu"], EPS, True, f32)
        return [_jax_out(y, h, w), m, v]
    if kind == "bn_dw":
        y, m, v = js._run_bn_dw(_jax_in(x, rows), bn, jnp.asarray(d["k"]), h,
                                w, d["relu"], EPS, True, f32)
        return [_jax_out(y, h, w), m, v]
    if kind == "bn_dw_s2":
        y, m, v = js._run_bn_dw_s2(_jax_in(x, rows), bn, jnp.asarray(d["k"]),
                                   h, w, rows2, EPS, True, f32,
                                   relu=d["relu"])
        return [_jax_out(y, d["ho"], d["ho"]), m, v]
    co = d["gy"].shape[-1]
    pn = (js._bnbwd_identity(co) if d["ident"] else jnp.asarray(d["pn"]))
    grows = rows2 if kind == "dw_s2_bwd" else rows
    gy, an = _jax_in(d["gy"], grows), _jax_in(d["an"], grows)
    ak = _jax_in(x, rows)
    if kind == "pw_bwd":
        gyk, s, dw = js._run_pw_bwd(gy, an, ak, pn, bn, jnp.asarray(d["w"]),
                                    h, w, d["relu"], EPS, True, f32)
    elif kind == "dw_bwd":
        gyk, s, dw = js._run_dw_bwd(gy, an, ak, pn, bn, jnp.asarray(d["k"]),
                                    h, w, EPS, True, f32, relu_k=d["relu"])
    else:
        gyk, s, dw = js._run_dw_s2_bwd(gy, an, ak, pn, bn,
                                       jnp.asarray(d["k"]), h, w, EPS, True,
                                       f32, relu_k=d["relu"])
    return [_jax_out(gyk, h, w), s, dw]


@pytest.mark.parametrize("name", list(PASSES))
def test_plain_pass_matches_jax_runner(name):
    kind, d = _pass_inputs(name)
    got = _port_pass(kind, d)
    want = _jax_pass(kind, d)
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0].numpy(), want[0], err_msg="values",
                               **VAL)
    for what, g, w in zip(("sums/mean", "dW/var"), got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=what,
                                   **SUM)


@pytest.mark.parametrize("kwargs", [dict(relu="gelu"), dict(dil=3)])
def test_passes_refuse_what_the_kernels_do_not_take(kwargs):
    """An activation other than none, relu6 and relu, and a dilation other
    than 1, 2 and 4, raise, on any device."""
    x = torch.zeros(1, 5, 5, 8)
    k = torch.zeros(8, 9)
    with pytest.raises(ValueError):
        tst.run_bn_dw(x, None, k, kwargs.get("relu", True),
                      dil=kwargs.get("dil", 1))


# ---------------------------------------------------------------------------
# (b) the chains
# ---------------------------------------------------------------------------

def _stem_params(seed=0):
    rng = np.random.RandomState(seed)
    p = {"k1": rng.randn(32, 9) * 0.5, "w1": rng.randn(16, 32) * 0.3,
         "w2": rng.randn(96, 16) * 0.3, "k2": rng.randn(96, 9) * 0.5,
         "w3": rng.randn(24, 96) * 0.2}
    for i, c in enumerate([32, 32, 16, 96, 96, 24]):
        p[f"g{i}"] = 1.0 + 0.3 * rng.randn(c)
        p[f"b{i}"] = 0.2 * rng.randn(c)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _ir_params(seed=7):
    rng = np.random.RandomState(seed)
    p = {}
    for i, (_, cin, ce, cout, _) in enumerate(tir._BLOCKS):
        p[f"we{i}"] = rng.randn(ce, cin) * 0.3
        p[f"k{i}"] = rng.randn(ce, 9) * 0.5
        p[f"wp{i}"] = rng.randn(cout, ce) * 0.2
        for tag, c in (("e", ce), ("d", ce), ("p", cout)):
            p[f"g{tag}{i}"] = 1.0 + 0.3 * rng.randn(c)
            p[f"b{tag}{i}"] = 0.2 * rng.randn(c)
    return {k: v.astype(np.float32) for k, v in p.items()}


# chain: (input shape, output cotangent shapes)
CHAINS = {
    "stem": ((2, 17, 17, 32), [(2, 9, 9, 24)]),
    "stem_even": ((1, 16, 16, 32), [(1, 8, 8, 24)]),
    "ir": ((2, 17, 17, 24), [(2, 9, 9, 32), (2, 17, 17, 24)]),
    "ir_even": ((1, 16, 16, 24), [(1, 8, 8, 32), (1, 16, 16, 24)]),
}


def _chain_data(name):
    shape, cots = CHAINS[name]
    rng = np.random.RandomState(11)
    x = rng.randn(*shape).astype(np.float32)
    ws = [rng.randn(*c).astype(np.float32) for c in cots]
    p = _stem_params() if name.startswith("stem") else _ir_params()
    return x, ws, p


@functools.cache
def _jax_chain(name):
    """(outputs, stats, loss, d input, d params) of the JAX chain."""
    import jax
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas.irchain import fused_ir_chain
    from kd_cheap_conv_tpu.ops.pallas.stem import fused_stem_f1f2

    x, ws, p = _chain_data(name)
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def run(x, p):
        if name.startswith("stem"):
            out, stats = fused_stem_f1f2(jnp.transpose(x, (0, 1, 3, 2)), p,
                                         EPS, True)
            return (out,), stats
        out, low, stats = fused_ir_chain(x, p, x.shape[0], EPS, True)
        return (out, low), stats

    def loss(x, p):
        outs, _ = run(x, p)
        return sum(jnp.sum(o.astype(jnp.float32) * w) for o, w in zip(outs, ws))

    outs, stats = run(jnp.asarray(x), jp)
    val, (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                             jp)
    return ([np.asarray(o) for o in outs],
            [(np.asarray(m), np.asarray(v)) for m, v in stats], float(val),
            np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()})


@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_matches_jax(name):
    x, ws, p = _chain_data(name)
    want_outs, want_stats, want_val, want_gx, want_gp = _jax_chain(name)
    tx = _t(x).requires_grad_()
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    if name.startswith("stem"):
        out, stats = tst.fused_stem_f1f2(tx, tp, EPS)
        outs = [out]
    else:
        out, low, stats = tir.fused_ir_chain(tx, tp, EPS)
        outs = [out, low]
    assert len(stats) == len(want_stats)
    for o, w in zip(outs, want_outs):
        assert o.shape == w.shape
        np.testing.assert_allclose(o.detach().numpy(), w, **VAL)
    for k, ((m, v), (wm, wv)) in enumerate(zip(stats, want_stats)):
        np.testing.assert_allclose(m.numpy(), wm, err_msg=f"mean{k}", **SUM)
        np.testing.assert_allclose(v.numpy(), wv, err_msg=f"var{k}", **SUM)
    loss = sum((o * _t(w)).sum() for o, w in zip(outs, ws))
    np.testing.assert_allclose(float(loss), want_val, rtol=1e-4)
    loss.backward()
    np.testing.assert_allclose(tx.grad.numpy(), want_gx, rtol=2e-3,
                               atol=2e-4, err_msg="d input")
    assert set(tp) == set(want_gp)
    for k in sorted(tp):
        np.testing.assert_allclose(tp[k].grad.numpy(), want_gp[k], rtol=2e-3,
                                   atol=2e-3, err_msg=f"d {k}")


# ---------------------------------------------------------------------------
# (c) the model, (d) the guards
# ---------------------------------------------------------------------------

def _jax_flat(state):
    from flax import nnx

    return {".".join(map(str, p)): np.asarray(v[...])
            for p, v in nnx.to_flat_state(state)}


@functools.cache
def _jax_mnv2():
    """(JAX model's leaves before the step, input, loss, grads and leaves
    after one train-mode forward with the fused chains and the f0-in-chain
    entry conv forced on, on the host-packed image)."""
    import jax.numpy as jnp
    from flax import nnx

    from kd_cheap_conv_tpu import config
    from kd_cheap_conv_tpu.models.mobilenetv2 import MobileNetV2
    from kd_cheap_conv_tpu.ops.conv import s2d_pack

    jm = MobileNetV2(output_stride=16, rngs=nnx.Rngs(0))
    before = _jax_flat(nnx.state(jm, nnx.Any(nnx.Param, nnx.BatchStat)))
    x = np.random.RandomState(42).randn(2, 33, 33, 3).astype(np.float32)

    def loss(model, x):
        out = model(x)
        return (jnp.sum(out["out"].astype(jnp.float32) ** 2)
                + jnp.sum(out["low_level"].astype(jnp.float32) ** 2))

    olds = (config.use_pallas_stem, config.use_pallas_ir,
            config.use_pallas_f0, config.use_host_s2d)
    try:
        (config.use_pallas_stem, config.use_pallas_ir, config.use_pallas_f0,
         config.use_host_s2d) = (True,) * 4
        assert jm._fused_stem_active() and jm._fused_ir_active()
        val, grads = nnx.value_and_grad(loss)(
            jm, jnp.asarray(s2d_pack(x, channel_sublane=True)))
    finally:
        (config.use_pallas_stem, config.use_pallas_ir, config.use_pallas_f0,
         config.use_host_s2d) = olds
    after = _jax_flat(nnx.state(jm, nnx.BatchStat))
    return before, x, float(val), _jax_flat(grads), after


def _count_plain_calls(monkeypatch):
    """Count the calls of each plain pass and entry-conv function (what the
    wrappers run on CPU tensors) by name."""
    counts = {}
    for name in ("bn_pw_ref", "bn_dw_ref", "pw_bwd_ref", "dw_bwd_ref",
                 "f0_ref", "f0_wgrad_ref", "f0_xgrad_ref"):
        orig = getattr(tst, name)

        def spy(*args, _orig=orig, _name=name, **kw):
            key = _name[:-4] + ("_s2" if "dw" in _name
                                and kw.get("stride", args[-1]) == 2 else "")
            counts[key] = counts.get(key, 0) + 1
            return _orig(*args, **kw)

        monkeypatch.setattr(tst, name, spy)
    return counts


def test_mobilenetv2_train_matches_jax_fused(monkeypatch):
    from kd_cheap_conv_tpu_torch.convert import state_dict_from_jax
    from kd_cheap_conv_tpu_torch.models.mobilenetv2 import MobileNetV2

    before, x, want_val, want_g, want_after = _jax_mnv2()
    tm = MobileNetV2(output_stride=16)
    tm.load_state_dict(state_dict_from_jax(before), strict=True)
    tm.train()
    assert tm._fused_stem_active() and tm._fused_ir_active()
    counts = _count_plain_calls(monkeypatch)
    out = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    loss = (out["out"] ** 2).sum() + (out["low_level"] ** 2).sum()
    loss.backward()
    # 11 1x1, 4 dw and 2 dw-s2 passes forward, as many backward; the entry
    # conv forward and its weight gradient, no image gradient
    assert counts == {"bn_pw": 11, "bn_dw": 4, "bn_dw_s2": 2, "pw_bwd": 11,
                      "dw_bwd": 4, "dw_bwd_s2": 2, "f0": 1,
                      "f0_wgrad": 1}, counts
    np.testing.assert_allclose(float(loss), want_val, rtol=1e-4)
    grads = state_dict_from_jax(want_g)
    named = dict(tm.named_parameters())
    assert set(grads) == set(named)
    for k, p in named.items():
        a, b = p.grad.numpy(), grads[k].numpy()
        # isolated relu6 clip-boundary flips (test_pallas_ir.py:162-165)
        bad = np.abs(a - b) > 1e-2 + 1e-2 * np.abs(b)
        assert bad.mean() <= 5e-3, f"{k}: {bad.sum()}/{bad.size} grads off"
        assert np.abs(a - b).max() < 0.1, k
    after = state_dict_from_jax(want_after)
    bns = [m for i in range(7) for m in tm.features[i].modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == 18
    sd = tm.state_dict()
    for k, v in after.items():
        if k.endswith("num_batches_tracked"):
            assert int(sd[k]) == 1, k           # one train-mode forward
            continue
        if int(k.split(".")[1]) <= 6:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", ["backbone_surgery", "entry_padding_0",
                                  "bias_in_f2", "eval"])
def test_guards_leave_chains_untaken(case, monkeypatch):
    from kd_cheap_conv_tpu_torch.kd.replace import replace_cheap_convs
    from kd_cheap_conv_tpu_torch.models import build_model
    from kd_cheap_conv_tpu_torch.models.layers import Conv2d

    m = build_model("deeplabv3plus_mobilenet", 6, 16,
                    generator=torch.Generator().manual_seed(0))
    bb = m.backbone.train()
    assert bb._fused_stem_active() and bb._fused_ir_active()
    if case == "backbone_surgery":
        assert replace_cheap_convs(m, scope="backbone") == [
            "backbone.features.0.conv"]
    elif case == "entry_padding_0":
        bb.features[0].conv.padding = (0, 0)
    elif case == "bias_in_f2":
        bb.features[2].pw_linear = Conv2d(96, 24, 1, use_bias=True)
    else:
        bb.eval()
    assert not bb._fused_stem_active()
    ref = copy.deepcopy(bb)
    counts = _count_plain_calls(monkeypatch)
    x = torch.randn(2, 3, 33, 33, generator=torch.Generator().manual_seed(1))
    got = bb(x)
    want = ref._forward_modules(x)
    assert counts == {}
    for k in ("low_level", "out"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   want[k].detach().numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_ir_guard_alone_keeps_the_stem():
    """A block of features[3..6] off the chain's shapes: the stem chain
    still runs, features[3..] run their modules."""
    from kd_cheap_conv_tpu_torch.models.mobilenetv2 import MobileNetV2

    m = MobileNetV2(output_stride=16).train()
    m.features[5].body[1].conv.dilation = (2, 2)
    m.features[5].body[1].conv.padding = (2, 2)
    assert m._fused_stem_active() and not m._fused_ir_active()
    ref = copy.deepcopy(m)
    x = torch.randn(2, 3, 33, 33, generator=torch.Generator().manual_seed(2))
    got, want = m(x), ref._forward_modules(x)
    for k in ("low_level", "out"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   want[k].detach().numpy(), rtol=1e-3,
                                   atol=1e-3)


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


def _card_args(name, dtype, dev):
    kind, d = _pass_inputs(name, n=2, hw=19, seed=3)
    bn = None if d["ident"] else _t(d["bn"]).to(dev)
    pn = None if d["ident"] else _t(d["pn"]).to(dev) if "pn" in d else None
    act = {k: _t(d[k]).to(dev, dtype) for k in ("x", "gy", "an") if k in d}
    wk = (_t(d["w"]).to(dev, dtype) if "w" in d else _t(d["k"]).to(dev))
    if kind.startswith("bn_"):
        return kind, (act["x"], bn, wk, d["relu"], EPS)
    return kind, (act["gy"], act["an"], act["x"], pn, bn, wk, d["relu"], EPS)


_REF = {"bn_pw": lambda *a: tst.bn_pw_ref(*a),
        "bn_dw": lambda *a: tst.bn_dw_ref(*a, stride=1),
        "bn_dw_s2": lambda *a: tst.bn_dw_ref(*a, stride=2),
        "pw_bwd": lambda *a: tst.pw_bwd_ref(*a),
        "dw_bwd": lambda *a: tst.dw_bwd_ref(*a, stride=1),
        "dw_s2_bwd": lambda *a: tst.dw_bwd_ref(*a, stride=2)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(PASSES))
def test_kernel_matches_plain_on_card(cuda, name, dtype):
    kind, args = _card_args(name, dtype, cuda)
    fn = getattr(tst, f"run_{kind}")
    before = fn.launches
    got = list(fn(*args))
    assert fn.launches == before + 1
    want = list(_REF[kind](*args))
    if kind.startswith("bn_"):            # moments from the plain sums
        want = [want[0], *tst._moments(want[1], tst._count(want[0]))]
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    for what, g, w in zip(("values", "sums", "weights"), got, want):
        g, w = g.float().cpu(), w.float().cpu()
        err = float((g - w).abs().max())
        assert err <= tol * max(float(w.abs().max()), 1e-6), (what, err)


@pytest.mark.gpu
def test_backward_kernels_are_deterministic(cuda):
    for name in ("pw_bwd", "dw_bwd", "dw_s2_bwd"):
        kind, args = _card_args(name, torch.bfloat16, cuda)
        fn = getattr(tst, f"run_{kind}")
        a, b = fn(*args), fn(*args)
        for x, y in zip(a, b):
            assert torch.equal(x, y), name


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(1, 5, 5, 8, device=cuda, dtype=torch.float64)
    k = torch.zeros(8, 9, device=cuda)
    with pytest.raises(TypeError):
        tst.run_bn_dw(x, None, k, True)
    xt = torch.zeros(1, 8, 5, 5, device=cuda).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tst.run_bn_dw(xt, None, k, True)
    with pytest.raises(ValueError, match="k must be"):
        tst.run_bn_dw(torch.zeros(1, 5, 5, 8, device=cuda), None,
                      k.double(), True)


# ---------------------------------------------------------------------------
# (e) the bf16 narrow 1x1 backward (one launch, csrc/bn_passes.cu nbw): its
# plan by hand on the CPU; on the card, every link of the config-#2 step at
# full size and the edges, against the plain version, twice bit for bit
# ---------------------------------------------------------------------------

# (P, ci, co) -> (CTAs, groups, scratch floats): ceil(P / 64) tiles on at
# most 132 CTAs, groups of 12, (CTAs + groups) partials of co ci + 2 ci
@pytest.mark.parametrize("p,ci,co,want", [
    (16 * 257 * 257, 16, 96, (132, 11, 143 * 1568)),
    (16 * 65 * 65, 192, 32, (132, 11, 143 * 6528)),
    (64 * 12, 24, 40, (12, 1, 13 * 1008)),
    (64 * 12 + 1, 24, 40, (13, 2, 15 * 1008)),
    (1, 10, 6, (1, 1, 2 * 80)),
])
def test_pw_bwd_plan_by_hand(p, ci, co, want):
    assert tst.pw_bwd_plan(p, ci, co) == want


# name: (a_k NHWC, Co, relu_k, input BN, next BN); the config-#2 step's
# distinct links (16 x 513², OS16: features[1..6]) and the edges: ragged
# pixel tiles, odd multiples of 8, widths that are not multiples of 8, no
# next BN, no input BN, no activation, plain relu, more CTAs than one group
# of the partials' sum, one pixel
NARROW_BWD = {
    "f1.pw": ((16, 257, 257, 32), 16, True, True, True),
    "f2.pwE": ((16, 257, 257, 16), 96, False, True, True),
    "f2.pwP": ((16, 129, 129, 96), 24, True, True, False),
    "f3.pwE": ((16, 129, 129, 24), 144, False, False, True),
    "f3.pwP": ((16, 129, 129, 144), 24, True, True, False),
    "f4.pwP": ((16, 65, 65, 144), 32, True, True, False),
    "f5.pwE": ((16, 65, 65, 32), 192, False, False, True),
    "f5.pwP": ((16, 65, 65, 192), 32, True, True, False),
    "ragged_24_40": ((1, 5, 13, 24), 40, True, True, True),
    "odd8_72_56_relu_no_next": ((2, 9, 11, 72), 56, "relu", True, False),
    "no_input_bn_40_88": ((3, 7, 9, 40), 88, False, False, True),
    "even_10_6": ((2, 7, 9, 10), 6, True, True, True),
    "groups_24_136": ((4, 61, 67, 24), 136, True, True, True),
    "one_pixel": ((1, 1, 1, 16), 96, True, True, True),
}


def _narrow_bwd_args(name, dtype, dev):
    shape, co, relu, has_bn, has_pn = NARROW_BWD[name]
    g = torch.Generator(device=dev).manual_seed(sorted(NARROW_BWD).index(name))
    n, h, w, ci = shape
    m = n * h * w

    def randn(*s, scale=1.0):
        return scale * torch.randn(s, device=dev, generator=g)

    bnk = (torch.stack([randn(ci, scale=0.1),
                        0.5 + torch.rand(ci, device=dev, generator=g),
                        1 + randn(ci, scale=0.2), randn(ci, scale=0.1)], 1)
           if has_bn else None)
    pn = (torch.stack([randn(co, scale=0.1),
                       0.5 + torch.rand(co, device=dev, generator=g),
                       1 + randn(co, scale=0.2), randn(co, scale=m ** 0.5),
                       randn(co, scale=m ** 0.5),
                       torch.full((co,), 1.0 / m, device=dev)], 1)
          if has_pn else None)
    return (randn(n, h, w, co).to(dtype), randn(n, h, w, co).to(dtype),
            randn(*shape).to(dtype), pn, bnk,
            randn(co, ci, scale=ci ** -0.5).to(dtype), relu, EPS)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(NARROW_BWD))
def test_narrow_backward_matches_plain_on_card(cuda, name, dtype):
    args = _narrow_bwd_args(name, dtype, cuda)
    before = tst.run_pw_bwd.launches
    got, again = tst.run_pw_bwd(*args), tst.run_pw_bwd(*args)
    assert tst.run_pw_bwd.launches == before + 2
    want = tst.pw_bwd_ref(*args)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    for what, a, b, w in zip(("gy_k", "sums", "dW"), got, again, want):
        assert torch.equal(a, b), what
        a, w = a.float(), w.float()
        err = float((a - w).abs().max())
        assert err <= tol * max(float(w.abs().max()), 1e-6), (what, err)


@pytest.mark.gpu
def test_pw_bwd_plan_mirrors_the_kernel(cuda):
    from kd_cheap_conv_tpu_torch import native

    lib = native.library()
    for shape, co, _, _, has_pn in NARROW_BWD.values():
        p, ci = shape[0] * shape[1] * shape[2], shape[3]
        grid, groups, floats = tst.pw_bwd_plan(p, ci, co)
        assert [lib.kdcc_pw_bwd_plan(k, p, ci, co, int(has_pn))
                for k in range(3)] == [grid, groups, floats]


# ---------------------------------------------------------------------------
# (f) the depthwise forward (one launch on one wave, csrc/bn_passes.cu dwf):
# its plan by hand on the CPU; on the card, the strides, dilations and
# activations at ragged widths and images against the plain version, with
# and without moments, twice bit for bit, and the plan's mirror
# ---------------------------------------------------------------------------

# (n, h, w, c, stride, dil, esize) -> (CTAs along x, slice, groups, scratch
# floats, tickets, tile rows). The slice is the widest 4 G (G <= 16
# dividing c / 4, whole 16-byte copies); th = 256 // G // 2 rows of 2 items
# of 8 outputs (stride 2: // 4, 4 items of 2), cut while the window's (3
# esize + 4) bytes a channel exceed 115712; CTAs = min(tiles, 264 //
# slices), groups of 24, scratch (CTAs + groups) x 2 c, tickets slices x
# (groups + 1). Config #2: f1.dw (also in float32), f2.dw, f3.dw; config
# #3: an entry block's stride 2 at 385², the exit flow's dilation 2 at 728
# and 1536.
@pytest.mark.parametrize("geo,want", [
    # G 8, cs 32: th 16 (18 x 18 x 32 x 10 = 103680); 16 x 17 x 17 tiles
    ((16, 257, 257, 32, 1, 1, 2), (264, 32, 11, 275 * 64, 12, 16)),
    # float32: th 10 (12 x 18 x 32 x 16 = 110592)
    ((16, 257, 257, 32, 1, 1, 4), (264, 32, 11, 275 * 64, 12, 10)),
    # G 12, cs 48: th 21 // 4 = 5 (11 x 17 x 48 x 10 = 89760); 2 slices
    ((16, 257, 257, 96, 2, 1, 2), (132, 48, 6, 138 * 192, 14, 5)),
    # G 12: th 10 (12 x 18 x 48 x 10 = 103680); 3 slices, 16 x 13 x 9 tiles
    ((16, 129, 129, 144, 1, 1, 2), (88, 48, 4, 92 * 288, 15, 10)),
    # G 16, cs 64: th 4 (9 x 17 x 64 x 10 = 97920); 4 x 49 x 25 tiles
    ((4, 385, 385, 128, 2, 1, 2), (132, 64, 6, 138 * 256, 14, 4)),
    # G 14, cs 56: th 6 (10 x 20 x 56 x 10 = 112000); 13 slices, 4 x 9 x 4
    # tiles, 264 // 13 = 20 CTAs
    ((4, 49, 49, 728, 1, 2, 2), (20, 56, 1, 21 * 1456, 26, 6)),
    # G 16: th 5 (9 x 20 x 64 x 10 = 115200); 24 slices, 264 // 24 = 11
    ((4, 49, 49, 1536, 1, 2, 2), (11, 64, 1, 12 * 3072, 48, 5)),
])
def test_bn_dw_fwd_plan_by_hand(geo, want):
    assert tuple(tst.bn_dw_fwd_plan(*geo)) == want


def test_bn_dw_refuses_a_width_not_divisible_by_8():
    with pytest.raises(ValueError, match="divisible by 8"):
        tst._check_dw_width("bn_dw", 36)


# name: (x NHWC, stride, dilation, act, input BN); the edges: 728 = 13
# slices of 56 and 1536 = 24 of 64, ragged images, stride 2 on odd and even
# sizes, each activation, the identity BN, two levels of the moments' sum
DW_FWD = {
    "s1d1_728_relu": ((2, 23, 19, 728), 1, 1, "relu", True),
    "s1d2_728_none": ((2, 21, 30, 728), 1, 2, False, True),
    "s2_728_relu6": ((2, 23, 19, 728), 2, 1, True, True),
    "s1d1_40_relu6_identity": ((3, 17, 33, 40), 1, 1, True, False),
    "s2_96_none": ((1, 36, 18, 96), 2, 1, False, True),
    "s1d2_1536_relu": ((1, 13, 11, 1536), 1, 2, "relu", True),
    "groups_32_relu6": ((16, 65, 65, 32), 1, 1, True, True),
}


def _dw_fwd_args(name, dtype, dev):
    shape, _, _, _, has_bn = DW_FWD[name]
    g = torch.Generator(device=dev).manual_seed(sorted(DW_FWD).index(name))
    c = shape[-1]

    def randn(*s, scale=1.0):
        return scale * torch.randn(s, device=dev, generator=g)

    bn = (torch.stack([randn(c, scale=0.1),
                       0.5 + torch.rand(c, device=dev, generator=g),
                       1 + randn(c, scale=0.3), randn(c, scale=0.2)], 1)
          if has_bn else None)
    return randn(*shape).to(dtype), bn, randn(c, 9, scale=0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("moments", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(DW_FWD))
def test_dw_fwd_matches_plain_on_card(cuda, name, dtype, moments):
    _, stride, dil, relu, _ = DW_FWD[name]
    x, bn, k = _dw_fwd_args(name, dtype, cuda)
    fn = tst.run_bn_dw if stride == 1 else tst.run_bn_dw_s2
    kw = {"dil": dil} if stride == 1 else {}
    before = fn.launches
    got = fn(x, bn, k, relu, EPS, moments=moments, **kw)
    again = fn(x, bn, k, relu, EPS, moments=moments, **kw)
    assert fn.launches == before + 2
    y, sums = tst.bn_dw_ref(x, bn, k, relu, EPS, stride, dil)
    want = [y, *tst._moments(sums, tst._count(y))]
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    for what, a, b, w in zip(("y", "mean", "var"), got, again, want):
        if what != "y" and not moments:
            assert a is None and b is None
            continue
        assert torch.equal(a, b), what
        a, w = a.float(), w.float()
        err = float((a - w).abs().max())
        assert err <= tol * max(float(w.abs().max()), 1e-6), (what, err)


@pytest.mark.gpu
def test_bn_dw_fwd_plan_mirrors_the_kernel(cuda):
    from kd_cheap_conv_tpu_torch import native

    lib = native.library()
    geos = [(*shape, s, d) for shape, s, d, _, _ in DW_FWD.values()]
    geos += [(16, 257, 257, 32, 1, 1), (16, 129, 129, 144, 2, 1),
             (4, 49, 49, 728, 1, 1), (4, 385, 385, 64, 1, 1)]
    for geo in geos:
        for dt, esize in ((0, 4), (1, 2)):
            want = list(tst.bn_dw_fwd_plan(*geo, esize))
            assert [lib.kdcc_bn_dw_fwd_plan(k, dt, *geo)
                    for k in range(6)] == want, (geo, esize)


# ---------------------------------------------------------------------------
# (g) the bf16 narrow 1x1 forward (one launch on one wave, csrc/bn_passes.cu
# npf): its plan by hand on the CPU; on the card, every link of the
# config-#2 step and the edges against the plain version, with and without
# moments, twice bit for bit, and the plan's mirror
# ---------------------------------------------------------------------------

# (P, ci, co) -> (CTAs, groups, scratch floats, stages): min(ceil(P / 128),
# 132) CTAs, groups of 12, (CTAs + groups) x 2 co floats; the stages of
# 128 x ci x 2 bytes that fit beside h and W (2 (128 + r16(co)) (r16(ci) +
# 8) bytes), the y staging (128 x 16 ((co / 8) | 1)), the tile's sums
# (8 x 2 co x 4) and 16, at most 4
@pytest.mark.parametrize("p,ci,co,want", [
    # f2.pwE: fixed 10752 + 26624 + 6144 + 16 = 43536; 4096-byte stages
    (16 * 257 * 257, 16, 96, (132, 11, 143 * 192, 4)),
    # f5.pwP: fixed 64000 + 10240 + 2048 + 16 = 76304; 49152-byte stages: 3
    (16 * 65 * 65, 192, 32, (132, 11, 143 * 64, 3)),
    # f5.pwE: fixed 25600 + 51200 + 12288 + 16 = 89104; 8192-byte stages
    (16 * 65 * 65, 32, 192, (132, 11, 143 * 384, 4)),
    # ceil(722 / 128) = 6 CTAs, one group
    (2 * 19 * 19, 24, 32, (6, 1, 7 * 64, 4)),
    # 13 CTAs: two groups (12, 1)
    (128 * 13, 8, 8, (13, 2, 15 * 16, 4)),
    (1, 144, 24, (1, 1, 2 * 48, 4)),
])
def test_bn_pw_fwd_plan_by_hand(p, ci, co, want):
    assert tst.bn_pw_fwd_plan(p, ci, co) == want


@pytest.mark.parametrize("ci,co", [(10, 16), (16, 6), (200, 8), (96, 96)])
def test_bn_pw_fwd_plan_refuses_what_the_kernel_does_not_take(ci, co):
    with pytest.raises(ValueError, match="divisible by 8"):
        tst.bn_pw_fwd_plan(64, ci, co)


# name: (x NHWC, Co, relu, input BN); the config-#2 step's distinct links
# (16 x 513², OS16: features[1..6]) and the edges: ragged pixel tiles, no
# input BN, plain relu, no activation, more CTAs than one group of the
# moments' sum, one pixel
NARROW_FWD = {
    "f1.pw": ((16, 257, 257, 32), 16, True, True),
    "f2.pwE": ((16, 257, 257, 16), 96, False, True),
    "f2.pwP": ((16, 129, 129, 96), 24, True, True),
    "f3.pwE": ((16, 129, 129, 24), 144, False, False),
    "f3.pwP": ((16, 129, 129, 144), 24, True, True),
    "f4.pwP": ((16, 65, 65, 144), 32, True, True),
    "f5.pwE": ((16, 65, 65, 32), 192, False, False),
    "f5.pwP": ((16, 65, 65, 192), 32, True, True),
    "ragged_24_40_relu": ((1, 5, 13, 24), 40, "relu", True),
    "groups_40_88_none": ((4, 29, 31, 40), 88, False, True),
    "one_pixel": ((1, 1, 1, 16), 96, True, True),
}


def _narrow_fwd_args(name, dtype, dev):
    shape, co, relu, has_bn = NARROW_FWD[name]
    g = torch.Generator(device=dev).manual_seed(sorted(NARROW_FWD).index(name))
    ci = shape[-1]

    def randn(*s, scale=1.0):
        return scale * torch.randn(s, device=dev, generator=g)

    bn = (torch.stack([randn(ci, scale=0.1),
                       0.5 + torch.rand(ci, device=dev, generator=g),
                       1 + randn(ci, scale=0.2), randn(ci, scale=0.3)], 1)
          if has_bn else None)
    return (randn(*shape).to(dtype), bn,
            randn(co, ci, scale=ci ** -0.5).to(dtype), relu, EPS)


@pytest.mark.gpu
@pytest.mark.parametrize("moments", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(NARROW_FWD))
def test_narrow_forward_matches_plain_on_card(cuda, name, dtype, moments):
    args = _narrow_fwd_args(name, dtype, cuda)
    before = tst.run_bn_pw.launches
    got = tst.run_bn_pw(*args, moments=moments)
    again = tst.run_bn_pw(*args, moments=moments)
    assert tst.run_bn_pw.launches == before + 2
    y, sums = tst.bn_pw_ref(*args)
    want = [y, *tst._moments(sums, tst._count(y))]
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    for what, a, b, w in zip(("y", "mean", "var"), got, again, want):
        if what != "y" and not moments:
            assert a is None and b is None
            continue
        assert torch.equal(a, b), what
        a, w = a.float(), w.float()
        err = float((a - w).abs().max())
        assert err <= tol * max(float(w.abs().max()), 1e-6), (what, err)


@pytest.mark.gpu
def test_bn_pw_fwd_plan_mirrors_the_kernel(cuda):
    from kd_cheap_conv_tpu_torch import native

    lib = native.library()
    shapes = [(s[0] * s[1] * s[2], s[3], co)
              for s, co, _, _ in NARROW_FWD.values()]
    shapes += [(128 * 13, 8, 8), (16 * 257 * 257, 192, 32)]
    for p, ci, co in shapes:
        assert [lib.kdcc_bn_pw_fwd_plan(k, p, ci, co) for k in range(4)] \
            == list(tst.bn_pw_fwd_plan(p, ci, co)), (p, ci, co)
    assert lib.kdcc_bn_pw_fwd_plan(0, 64, 10, 16) == -1
