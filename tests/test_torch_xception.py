"""The port's Xception-65 and its train-mode chains
(kd_cheap_conv_tpu_torch.models.xception, ops.xchain) against the JAX
package's.

- (a) The backbone against the JAX Xception65 on its stock path (the JAX
  default on the CPU), the middle flow trimmed to 2 blocks, full widths, 2
  images at 65², f32, weights moved with `state_dict_from_jax`: in train
  mode `out` and `low_level`, every parameter gradient and every BN's
  running statistics, then the eval forward. Tolerances of the JAX file
  tests/test_pallas_xchain.py:156-230 (values rtol 1e-4; gradients at most
  5e-3 of the entries off by more than 1e-2 + 1e-2 |g|; running statistics
  rtol 1e-4, atol 1e-5; eval rtol 2e-4, atol 2e-3). The port's train mode
  goes through its chains (their plain passes on the CPU, counted).
- (b) The port's chain path against its module path on that model, in f64:
  values and gradients to 1e-9 of their scale, batch statistics to 1e-7
  (the module BN's running variance passes through f32).
- (c) Each chain against its JAX counterpart with the Pallas kernels in
  interpret mode, at the JAX tests' sizes: the middle flow at C = 16, 2 x
  9 x 11, 2 blocks, dilation 1 and 2; the exit flow at the _TA / _TB widths
  (/8), 2 x 11 x 9, at dilation 2 (OS16) and 4 (OS8, pad 4 on a 9-wide
  map); an entry block at 8 -> 16 -> 16 -> 24 channels, 2 x 9
  x 11 (odd H), with act1 False and "relu". Values, the stats tuple and the
  gradients of the input and every parameter, rtol 1e-4 and atol 1e-4 of
  each tensor's largest magnitude (for the parameter gradients, of the
  largest of them all: a depthwise BN's beta gradient is zero up to
  rounding, since the next train BN removes a per-channel shift). The JAX
  chains' `_bnbwd_identity` (the "next BN" of each segment's last 1x1
  link) scales gradients by rsqrt(1 + 1e-5) = 1 - 5e-6 where the port's
  identity is exact: 20x inside that tolerance.
- (d) `state_dict_from_jax` loads a JAX `deeplabv3plus_xception` strictly.
  The train guards on meta-device models: at OS8 the middle flow (dilation
  2) and the exit flow (dilation 4) take the chains and block3 (stride 1)
  its modules; at OS32 the exit flow (stride 2) its modules. The passes
  take dilation 4 and refuse 3; the depthwise forward's plan at dilation 4
  by hand.
- (e) `gpu` cases: each widened and new pass kernel against its plain
  version on the card at Xception widths (relu, dilation 2, channel blocks
  past 512, the wide 1x1 forward and its two backward kernels), the
  depthwise backward also at the edges of its card-sized grid (728
  channels at tile edges, stride 2 at 64 channels with odd sizes, one
  pixel), the wide 1x1 backward across several pixel tiles, K chunks and
  weight-gradient splits with ragged edges, the dilation-4 depthwise
  forward and backward (OS8's exit flow: 728, 1024 and 1536 channels at
  tile edges and on maps smaller than the halo), and the backward kernels
  twice, bit for bit; the depthwise forward's plan at dilation 4 against
  the kernel's own; they skip where there is no card. On the CPU, the
  weight gradient's split plan (`xpw_wgrad_plan`) at the step's shapes.
"""

import functools

import numpy as np
import pytest
import torch

from kd_cheap_conv_tpu_torch.convert import state_dict_from_jax
from kd_cheap_conv_tpu_torch.ops import stem as tst
from kd_cheap_conv_tpu_torch.ops import xchain as txc

torch.set_num_threads(1)

EPS = 1e-5
HW = 65


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def jax_leaves(module) -> dict:
    from flax import nnx

    flat = nnx.to_flat_state(nnx.state(module, nnx.Any(nnx.Param,
                                                       nnx.BatchStat)))
    return {".".join(map(str, p)): np.asarray(v[...]) for p, v in flat}


def _materialize(abstract, seed):
    """An abstract JAX module (nnx.eval_shape) with seeded numpy values:
    conv kernels ~N(0, 2 / fan-out), BN scales 1 + 0.2 N(0, 1), biases
    0.1 N(0, 1), running mean 0 and variance 1. Faster on the CPU than the
    model's own initialisers, eager or jitted."""
    import re

    import jax
    import jax.numpy as jnp
    from flax import nnx

    rng = np.random.RandomState(seed)
    graphdef, state = nnx.split(abstract)

    def fill(path, leaf):
        name = [k for k in re.findall(r"'(\w+)'", jax.tree_util.keystr(path))
                if k != "value"][-1]
        shape = leaf.shape
        if name == "kernel":
            # the models' variance_scaling(2, fan_out) (HWIO kernels)
            v = rng.randn(*shape) * np.sqrt(2.0 / (shape[0] * shape[1]
                                                   * shape[3]))
        elif name == "scale":
            v = 1 + 0.2 * rng.randn(*shape)
        elif name == "bias":
            v = 0.1 * rng.randn(*shape)
        else:
            v = np.ones(shape) if name == "var" else np.zeros(shape)
        return jnp.asarray(v.astype(np.float32))

    return nnx.merge(graphdef,
                     jax.tree_util.tree_map_with_path(fill, state))


# ---------------------------------------------------------------------------
# (a), (b): the backbone
# ---------------------------------------------------------------------------

@functools.cache
def _jax_abstract():
    """The JAX deeplabv3plus_xception (19 classes, OS16), abstract."""
    from flax import nnx

    from kd_cheap_conv_tpu.models import build_model as jax_build

    return nnx.eval_shape(lambda: jax_build("deeplabv3plus_xception", 19, 16,
                                            rngs=nnx.Rngs(0)))


@functools.cache
def _backbone_run():
    """The JAX model's Xception65 (middle trimmed to 2 blocks, seeded
    weights) in train mode on its stock path: (initial leaves, x, w_out,
    w_low, out, low, param grads, leaves after the step, x_eval, eval
    out)."""
    import jax
    import jax.numpy as jnp
    from flax import nnx

    ab = nnx.merge(*nnx.split(_jax_abstract().backbone))   # a fresh copy
    ab.middle = nnx.List([ab.middle[0], ab.middle[1]])
    jm = _materialize(ab, 3)
    leaves = jax_leaves(jm)
    rng = np.random.RandomState(42)
    x = rng.randn(2, HW, HW, 3).astype(np.float32)
    w_out = rng.randn(2, 5, 5, 2048).astype(np.float32)
    w_low = rng.randn(2, 17, 17, 128).astype(np.float32)

    def loss(model, x):
        o = model(x)
        return (jnp.sum(o["out"] * w_out) + jnp.sum(o["low_level"] * w_low),
                o)

    step = nnx.jit(lambda m, x: nnx.value_and_grad(loss, has_aux=True)(m, x))
    (_, o), g = step(jm, jnp.asarray(x))
    grads = {".".join(map(str, p)): np.asarray(v[...])
             for p, v in nnx.to_flat_state(g)}
    after = jax_leaves(jm)
    jm.eval()
    xe = np.random.RandomState(43).randn(2, HW, HW, 3).astype(np.float32)
    out_eval = np.asarray(nnx.jit(lambda m, x: m(x)["out"])(
        jm, jnp.asarray(xe)))
    jax.clear_caches()
    return (leaves, x, w_out, w_low, np.asarray(o["out"]),
            np.asarray(o["low_level"]), grads, after, xe, out_eval)


def _port_backbone(leaves, dtype=torch.float32):
    from kd_cheap_conv_tpu_torch.models.xception import Xception65

    m = Xception65(output_stride=16)
    m.middle = torch.nn.ModuleList(list(m.middle)[:2])
    m.load_state_dict(state_dict_from_jax(leaves), strict=True)
    return m.to(dtype=dtype, memory_format=torch.channels_last).train()


def _nchw(a, dtype=torch.float32):
    return _t(a, dtype).permute(0, 3, 1, 2)


def _count_chain_passes(monkeypatch):
    calls = {"pw": 0, "dw": 0, "dw_s2": 0}
    for name, key in (("run_bn_pw", "pw"), ("run_bn_dw", "dw"),
                      ("run_bn_dw_s2", "dw_s2")):
        orig = getattr(txc, name)

        def spy(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(txc, name, spy)
    return calls


def _port_step(m, x, w_out, w_low, modules=False, dtype=torch.float32):
    xt = _nchw(x, dtype).contiguous(memory_format=torch.channels_last)
    o = m._forward_modules(xt) if modules else m(xt)
    loss = ((o["out"] * _nchw(w_out, dtype)).sum()
            + (o["low_level"] * _nchw(w_low, dtype)).sum())
    loss.backward()
    return o


def test_backbone_train_and_eval_match_jax(monkeypatch):
    (leaves, x, w_out, w_low, out, low, grads, after, xe,
     out_eval) = _backbone_run()
    m = _port_backbone(leaves)
    assert (m._fused_entry_ok(m.block1) and m._fused_middle_active()
            and m._fused_tail_active())
    calls = _count_chain_passes(monkeypatch)
    o = _port_step(m, x, w_out, w_low)
    # 3 entry blocks (3 pw, 2 dw, 1 dw_s2), 2 middle blocks (3 pw, 3 dw),
    # the exit flow (6 pw, 6 dw)
    assert calls == {"pw": 9 + 6 + 6, "dw": 6 + 6 + 6, "dw_s2": 3}
    for name, got, want in (("out", o["out"], out),
                            ("low_level", o["low_level"], low)):
        np.testing.assert_allclose(
            got.detach().permute(0, 2, 3, 1).numpy(), want, rtol=1e-4,
            atol=1e-4 * float(np.abs(want).max()), err_msg=name)
    want_g = state_dict_from_jax(grads)
    for name, p in m.named_parameters():
        a, b = p.grad.numpy(), want_g[name].numpy()
        bad = np.abs(a - b) > 1e-2 + 1e-2 * np.abs(b)
        assert bad.mean() <= 5e-3, f"{name}: {bad.sum()}/{bad.size} off"
    want_s = state_dict_from_jax(after)
    for name, buf in m.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_s[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
    m.eval()
    with torch.no_grad():
        got = m(_nchw(xe).contiguous(memory_format=torch.channels_last))
    np.testing.assert_allclose(got["out"].permute(0, 2, 3, 1).numpy(),
                               out_eval, rtol=2e-4, atol=2e-3)


def test_chain_path_matches_module_path_f64():
    leaves, x, w_out, w_low = _backbone_run()[:4]
    f64 = torch.float64
    chains, mods = _port_backbone(leaves, f64), _port_backbone(leaves, f64)
    oc = _port_step(chains, x, w_out, w_low, dtype=f64)
    om = _port_step(mods, x, w_out, w_low, modules=True, dtype=f64)
    for k in ("out", "low_level"):
        scale = float(om[k].abs().max())
        assert float((oc[k] - om[k]).abs().max()) <= 1e-9 * scale, k
    gscale = max(float(p.grad.abs().max()) for p in mods.parameters())
    for (name, a), (_, b) in zip(chains.named_parameters(),
                                 mods.named_parameters()):
        assert float((a.grad - b.grad).abs().max()) <= 1e-9 * gscale, name
    for (name, a), (_, b) in zip(chains.named_buffers(),
                                 mods.named_buffers()):
        if name.endswith("num_batches_tracked"):
            assert int(a) == int(b) == 1, name
        else:
            err = float((a - b).abs().max())
            assert err <= 1e-7 * max(1.0, float(b.abs().max())), name


# ---------------------------------------------------------------------------
# (c) each chain against its JAX counterpart (interpret mode)
# ---------------------------------------------------------------------------

def _sep_params(rng, p, tag, ci, co):
    p[f"k{tag}"] = (0.4 * rng.randn(ci, 9)).astype(np.float32)
    p[f"w{tag}"] = (0.3 * rng.randn(co, ci)).astype(np.float32)
    for t, c in (("gd", ci), ("bd", ci), ("gp", co), ("bp", co)):
        v = 1 + 0.2 * rng.randn(c) if t[0] == "g" else 0.2 * rng.randn(c)
        p[f"{t}{tag}"] = v.astype(np.float32)


def _skip_params(rng, p, ci, co):
    p["wsk"] = (0.2 * rng.randn(co, ci)).astype(np.float32)
    p["gsk"] = (1 + 0.2 * rng.randn(co)).astype(np.float32)
    p["bsk"] = (0.2 * rng.randn(co)).astype(np.float32)


_TA = ((91, 91, "relu"), (91, 128, "relu"), (128, 128, "relu"))
_TB = ((128, 192, False), (192, 192, "relu"), (192, 256, "relu"))
_ENTRY = (8, 16, 16, 24)

# name: (chain, input shape, extra)
CHAINS = {
    "middle_d1": ("middle", (2, 9, 11, 16), 1),
    "middle_d2": ("middle", (2, 9, 11, 16), 2),
    "tail": ("tail", (2, 11, 9, 91), 2),
    "tail_d4": ("tail", (2, 11, 9, 91), 4),
    "entry_no_act": ("entry", (2, 9, 11, _ENTRY[0]), False),
    "entry_relu": ("entry", (2, 9, 11, _ENTRY[0]), "relu"),
}


def _chain_case(name):
    kind, shape, extra = CHAINS[name]
    rng = np.random.RandomState(sorted(CHAINS).index(name))
    p = {}
    if kind == "middle":
        for b in range(2):
            for i in range(3):
                _sep_params(rng, p, f"{b}_{i}", shape[-1], shape[-1])
    elif kind == "tail":
        for pre, specs in (("eb", _TA), ("es", _TB)):
            for j, (ci, co, _) in enumerate(specs):
                _sep_params(rng, p, f"{pre}{j}", ci, co)
        _skip_params(rng, p, _TA[0][0], _TA[2][1])
    else:
        for i in range(3):
            _sep_params(rng, p, str(i), _ENTRY[i], _ENTRY[i + 1])
        _skip_params(rng, p, _ENTRY[0], _ENTRY[3])
    x = rng.randn(*shape).astype(np.float32)
    return kind, extra, x, p, rng


def _jax_chain(kind, extra, x, p, w):
    """The JAX chain's (out, stats, dx, dparams), forward and vjp in one
    jitted trace (interpret mode)."""
    import jax
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas import xchain as jxc

    def run(x, p):
        if kind == "middle":
            return jxc.fused_x_middle_train(x, p, 2, EPS, True, extra)
        if kind == "tail":
            return jxc.fused_x_tail_train(x, p, extra, EPS, True, (_TA, _TB))
        return jxc.fused_x_entry_block_train(x, p, extra, EPS, True)

    @jax.jit
    def go(x, p):
        (out, stats), vjp = jax.vjp(run, x, p)
        gx, gp = vjp((jnp.asarray(w), jax.tree.map(jnp.zeros_like, stats)))
        return out, stats, gx, gp

    out, stats, gx, gp = go(jnp.asarray(x),
                            {k: jnp.asarray(v) for k, v in p.items()})
    jax.clear_caches()
    return (np.asarray(out), [tuple(map(np.asarray, mv)) for mv in stats],
            np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()})


def _port_chain(kind, extra, x, p, w):
    xt = _t(x).requires_grad_()
    pt = {k: _t(v).requires_grad_() for k, v in p.items()}
    if kind == "middle":
        out, stats = txc.fused_x_middle_train(xt, pt, 2, EPS, extra)
    elif kind == "tail":
        out, stats = txc.fused_x_tail_train(xt, pt, extra, EPS, (_TA, _TB))
    else:
        out, stats = txc.fused_x_entry_block_train(xt, pt, extra, EPS)
    (out * _t(w)).sum().backward()
    return (out.detach().numpy(), [(m.numpy(), v.numpy()) for m, v in stats],
            xt.grad.numpy(), {k: v.grad.numpy() for k, v in pt.items()})


def _close(got, want, what, scale=None):
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * max(scale, 1e-6), err_msg=what)


@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_matches_jax_interpret(name):
    kind, extra, x, p, rng = _chain_case(name)
    ho = (x.shape[1] + 1) // 2 if kind == "entry" else x.shape[1]
    wo = (x.shape[2] + 1) // 2 if kind == "entry" else x.shape[2]
    co = {"middle": x.shape[-1], "tail": _TB[-1][1], "entry": _ENTRY[3]}
    w = rng.randn(x.shape[0], ho, wo, co[kind]).astype(np.float32)
    got = _port_chain(kind, extra, x, p, w)
    want = _jax_chain(kind, extra, x, p, w)
    assert got[0].shape == want[0].shape
    _close(got[0], want[0], "values")
    assert len(got[1]) == len(want[1])
    for i, (g, wv) in enumerate(zip(got[1], want[1])):
        _close(g[0], wv[0], f"mean {i}")
        _close(g[1], wv[1], f"var {i}")
    _close(got[2], want[2], "dx")
    assert sorted(got[3]) == sorted(want[3])
    # one scale for the parameter gradients: the depthwise BNs' beta
    # gradients are zero up to rounding (the next train BN removes a
    # per-channel shift), so their own magnitude is no yardstick
    scale = max(float(np.abs(v).max()) for v in want[3].values())
    for k in sorted(p):
        _close(got[3][k], want[3][k], f"d {k}", scale)


# ---------------------------------------------------------------------------
# (d) the converter
# ---------------------------------------------------------------------------

def test_state_dict_from_jax_loads_deeplabv3plus_xception():
    from kd_cheap_conv_tpu_torch.models import build_model

    leaves = jax_leaves(_materialize(_jax_abstract(), 4))
    tm = build_model("deeplabv3plus_xception", 19, 16)
    sd = state_dict_from_jax(leaves)
    tm.load_state_dict(sd, strict=True)
    assert len(sd) == len(tm.state_dict())
    for key in ("backbone.middle.15.sep3.sep.pointwise.kernel",
                "backbone.exit_sep3.sep.depthwise.kernel",
                "backbone.block1.skip_conv.kernel"):
        want = torch.from_numpy(leaves[key].transpose(3, 2, 0, 1).copy())
        got = tm.state_dict()[key.replace(".kernel", ".weight")]
        assert torch.equal(got, want), key


def _meta_xception(os):
    """A train-mode Xception65 without storage: the guards read structure
    only."""
    from kd_cheap_conv_tpu_torch.models.xception import Xception65

    with torch.device("meta"):
        return Xception65(output_stride=os).train()


def test_train_guards_take_the_chains_at_os8():
    m8 = _meta_xception(8)
    # block3 has stride 1 at OS8: on its modules, as in the JAX package
    assert [m8._fused_entry_ok(b) for b in (m8.block1, m8.block2,
                                            m8.block3)] == [True, True, False]
    assert m8._fused_middle_active() and m8._fused_tail_active()
    assert m8.middle[0].sep1.sep.depthwise.dilation[0] == 2
    assert m8.exit_block.sep1.sep.depthwise.dilation[0] == 4
    m32 = _meta_xception(32)
    # OS32's exit flow has stride 2: on its modules
    assert m32._fused_middle_active() and not m32._fused_tail_active()
    m8.eval()
    assert not (m8._fused_middle_active() or m8._fused_tail_active())


def test_passes_take_dilation_4_and_refuse_3():
    tst._check_args("relu", 4)
    with pytest.raises(ValueError, match="dilation"):
        tst._check_args("relu", 3)
    x, k = torch.zeros(1, 5, 5, 8), torch.zeros(8, 9)
    with pytest.raises(ValueError, match="dilation"):
        tst.run_bn_dw(x, None, k, "relu", dil=3)
    assert tst.run_bn_dw(x, None, k, "relu", dil=4)[0].shape == x.shape


# the depthwise forward's plan at dilation 4 (n, h, w, c, stride, dil, esize)
# -> (CTAs along x, slice, groups, scratch floats, tickets, tile rows), by
# hand: a tile row is 16 outputs, so the window is (th + 8) x 24 pixels at
# (3 esize + 4) bytes a channel within 115712 bytes, at the widest slice
# 4 G (G <= 16 dividing c / 4, whole 16-byte copies) whose window fits at
# some th >= 1, th from 256 // G // 2 down; CTAs min(tiles, 264 // slices)
@pytest.mark.parametrize("geo,want", [
    # G 14 (56) fails even at th 1 (9 x 24 x 56 x 10 = 120960); G 13 and 7
    # are odd (8-byte copies); G 2: cs 8, th 64 -> 52 (60 x 24 x 8 x 10 =
    # 115200); 91 slices, 264 // 91 = 2 CTAs; 182 tickets
    ((4, 97, 97, 728, 1, 4, 2), (2, 8, 1, 3 * 1456, 182, 52)),
    # G 16 fails at th 1 (138240); G 8: cs 32, th 16 -> 7 (15 x 24 x 32 x 10
    # = 115200); 32 slices, 8 CTAs
    ((4, 97, 97, 1024, 1, 4, 2), (8, 32, 1, 9 * 2048, 64, 7)),
    # G 12: cs 48, th 10 -> 2 (10 x 24 x 48 x 10 = 115200); 32 slices
    ((4, 97, 97, 1536, 1, 4, 2), (8, 48, 1, 9 * 3072, 64, 2)),
    # float32: G 7, cs 28, th 18 -> 2 (10 x 24 x 28 x 16 = 107520); 26
    # slices, 264 // 26 = 10 CTAs
    ((4, 97, 97, 728, 1, 4, 4), (10, 28, 1, 11 * 1456, 52, 2)),
])
def test_bn_dw_fwd_plan_at_dilation_4_by_hand(geo, want):
    assert tuple(tst.bn_dw_fwd_plan(*geo)) == want


# ---------------------------------------------------------------------------
# (e) the kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# name: (pass, input NHWC, Co, act, dilation, input BN)
CARD = {
    "bn_dw_relu_d1_728": ("bn_dw", (2, 13, 11, 728), 728, "relu", 1, True),
    "bn_dw_relu_d2_1536": ("bn_dw", (2, 9, 10, 1536), 1536, "relu", 2, True),
    "bn_dw_none_identity": ("bn_dw", (2, 9, 9, 1024), 1024, False, 2, False),
    "bn_dw_s2_relu_odd": ("bn_dw_s2", (2, 13, 15, 728), 728, "relu", 1, True),
    "dw_bwd_relu_d2": ("dw_bwd", (2, 9, 10, 1536), 1536, "relu", 2, True),
    "dw_bwd_relu_d1_identity": ("dw_bwd", (2, 11, 9, 728), 728, "relu", 1,
                                False),
    "dw_s2_bwd_relu_odd": ("dw_s2_bwd", (2, 13, 15, 256), 256, "relu", 1,
                           True),
    "bn_pw_wide_edges": ("bn_pw_wide", (2, 7, 9, 728), 1024, False, 1, True),
    "bn_pw_wide_relu": ("bn_pw_wide", (1, 5, 13, 64), 128, "relu", 1, False),
    "xpw_dgrad": ("xpw_dgrad", (2, 7, 9, 1024), 728, False, 1, True),
    "xpw_dgrad_identity": ("xpw_dgrad", (1, 6, 7, 128), 256, "relu", 1,
                           True),
    "xpw_wgrad": ("xpw_wgrad", (2, 7, 9, 1536), 2048, False, 1, True),
    "xpw_wgrad_relu": ("xpw_wgrad", (1, 6, 7, 64), 128, "relu", 1, True),
}
# the depthwise backward's edges on its card-sized grid: 728 channels (no
# slice of 64 divides them) at tile edges (13 x 15 against 8 x 8 tiles),
# stride 2 at 64 channels with odd sizes, a single pixel
CARD_DW = {
    "dw_bwd_tile_edge_728_d2": ("dw_bwd", (2, 13, 15, 728), 728, "relu", 2,
                                True),
    "dw_s2_bwd_64_odd": ("dw_s2_bwd", (3, 17, 19, 64), 64, "relu", 1, True),
    "dw_bwd_one_pixel": ("dw_bwd", (1, 1, 1, 1024), 1024, False, 1, True),
}
# the wide 1x1 backward kernels across several pixel tiles, K chunks and
# weight-gradient splits, with ragged last tiles and chunks and an input BN:
# the entry flow's 64 -> 128 with relu, the middle flow's own geometry
# (K = 728 ragged against 64-wide chunks), the exit flow's widest pass with
# the next BN, and a next BN of None ("identity")
CARD_XPW = {
    f"{kind}_{tag}": (kind, shape, co, act, 1, True)
    for kind in ("xpw_dgrad", "xpw_wgrad")
    for tag, shape, co, act in (
        ("97_64_relu", (1, 97, 97, 64), 128, "relu"),
        ("middle_728", (4, 49, 49, 728), 728, False),
        ("exit_1536", (1, 25, 25, 1536), 2048, False),
        ("ragged_identity", (2, 33, 35, 256), 728, "relu"))}
# dilation 4, OS8's exit flow: the depthwise forward at 1536 and 728
# channels (slices of 48 and 8) and the backward at 1024 and 728 on tile
# edges (13 x 15), with and without an input BN, and both on maps smaller
# than the 4-pixel halo
CARD_D4 = {
    "bn_dw_relu_d4_1536": ("bn_dw", (2, 13, 15, 1536), 1536, "relu", 4, True),
    "bn_dw_none_d4_728": ("bn_dw", (2, 13, 15, 728), 728, False, 4, True),
    "bn_dw_relu_d4_728_identity": ("bn_dw", (1, 9, 11, 728), 728, "relu", 4,
                                   False),
    "bn_dw_d4_below_halo_1024": ("bn_dw", (1, 3, 5, 1024), 1024, "relu", 4,
                                 True),
    "dw_bwd_relu_d4_1024": ("dw_bwd", (2, 13, 15, 1024), 1024, "relu", 4,
                            True),
    "dw_bwd_relu_d4_728": ("dw_bwd", (2, 13, 15, 728), 728, "relu", 4, True),
    "dw_bwd_none_d4_728_identity": ("dw_bwd", (1, 9, 11, 728), 728, False, 4,
                                    False),
    "dw_bwd_d4_below_halo_1024": ("dw_bwd", (1, 3, 5, 1024), 1024, "relu", 4,
                                  True),
}
CASES = {**CARD, **CARD_DW, **CARD_XPW, **CARD_D4}


def _card_args(name, dtype, dev):
    kind, shape, co, act, dil, has_bn = CASES[name]
    seed = (sorted(CARD).index(name) if name in CARD
            else len(CARD) + sorted(CARD_DW).index(name) if name in CARD_DW
            else len(CARD) + len(CARD_DW) + sorted(CARD_XPW).index(name)
            if name in CARD_XPW
            else len(CARD) + len(CARD_DW) + len(CARD_XPW)
            + sorted(CARD_D4).index(name))
    g = torch.Generator().manual_seed(seed)
    n, h, w, c = shape
    s = 2 if kind in ("bn_dw_s2", "dw_s2_bwd") else 1
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1

    def bn(c):
        return torch.stack([0.1 * torch.randn(c, generator=g),
                            0.5 + torch.rand(c, generator=g),
                            1 + 0.3 * torch.randn(c, generator=g),
                            0.2 * torch.randn(c, generator=g)], 1).to(dev)

    def act_t(*s):
        return torch.randn(*s, generator=g).to(dev, dtype)

    x = act_t(n, h, w, c)
    bnk = bn(c) if has_bn else None
    if kind in ("bn_dw", "bn_dw_s2", "dw_bwd", "dw_s2_bwd"):
        wk = (0.3 * torch.randn(c, 9, generator=g)).to(dev)
    else:
        wk = (torch.randn(co, c, generator=g) / c ** 0.5).to(dev, dtype)
    if kind.startswith("bn_"):
        extra = {"dil": dil} if kind == "bn_dw" else {}
        return kind, (x, bnk, wk, act, EPS), extra
    cn = co if kind.startswith("xpw") else c
    gy, an = act_t(n, ho, wo, cn), act_t(n, ho, wo, cn)
    pn = torch.cat([bn(cn)[:, :3], 5 * torch.randn(cn, 2, generator=g).to(dev),
                    torch.full((cn, 1), 1.0 / (n * ho * wo), device=dev)], 1)
    if name.endswith("identity") and kind.startswith("xpw"):
        pn = None
    extra = {"dil": dil} if kind == "dw_bwd" else {}
    return kind, (gy, an, x, pn, bnk, wk, act, EPS), extra


_REF = {"bn_dw": lambda *a, dil=1: tst.bn_dw_ref(*a, stride=1, dil=dil),
        "bn_dw_s2": lambda *a: tst.bn_dw_ref(*a, stride=2),
        "dw_bwd": lambda *a, dil=1: tst.dw_bwd_ref(*a, stride=1, dil=dil),
        "dw_s2_bwd": lambda *a: tst.dw_bwd_ref(*a, stride=2),
        "bn_pw_wide": tst.bn_pw_ref,
        "xpw_dgrad": tst.pw_dgrad_ref,
        "xpw_wgrad": lambda *a: (tst.pw_wgrad_ref(*a),)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CASES))
def test_pass_kernel_matches_plain_on_card(cuda, name, dtype):
    kind, args, extra = _card_args(name, dtype, cuda)
    fn = getattr(tst, f"run_{kind}")
    before = fn.launches
    got = fn(*args, **extra)
    got = list(got) if isinstance(got, tuple) else [got]
    assert fn.launches == before + 1
    want = list(_REF[kind](*args, **extra))
    if kind.startswith("bn_"):            # moments from the plain sums
        want = [want[0], *tst._moments(want[1], tst._count(want[0]))]
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    for what, g, w in zip(("values", "sums", "weights"), got, want):
        g, w = g.float().cpu(), w.float().cpu()
        err = float((g - w).abs().max())
        assert err <= tol * max(float(w.abs().max()), 1e-6), (what, err)


@pytest.mark.gpu
def test_widened_backward_kernels_are_deterministic(cuda):
    for name in ("dw_bwd_relu_d2", "dw_bwd_relu_d1_identity",
                 "dw_s2_bwd_relu_odd", *CARD_DW, "xpw_dgrad", "xpw_wgrad",
                 *CARD_XPW, *(n for n in CARD_D4 if n.startswith("dw_bwd"))):
        kind, args, extra = _card_args(name, torch.bfloat16, cuda)
        fn = getattr(tst, f"run_{kind}")
        a, b = fn(*args, **extra), fn(*args, **extra)
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        for x, y in zip(a, b):
            assert torch.equal(x, y), name


@pytest.mark.gpu
def test_bn_dw_fwd_plan_at_dilation_4_mirrors_the_kernel(cuda):
    from kd_cheap_conv_tpu_torch import native

    lib = native.library()
    geos = [(4, 97, 97, c, 1, 4) for c in (728, 1024, 1536)]
    geos += [(*v[1], 1, 4) for v in CARD_D4.values() if v[0] == "bn_dw"]
    for geo in geos:
        for dt, esize in ((0, 4), (1, 2)):
            want = list(tst.bn_dw_fwd_plan(*geo, esize))
            assert [lib.kdcc_bn_dw_fwd_plan(k, dt, *geo)
                    for k in range(6)] == want, (geo, esize)
            assert lib.kdcc_dw_bwd_grid(dt, *geo) >= 1, (geo, esize)
    assert lib.kdcc_bn_dw_fwd_plan(0, 1, 4, 97, 97, 728, 1, 3) == -1
    assert lib.kdcc_dw_bwd_grid(1, 4, 97, 97, 728, 1, 3) == -1
    assert lib.kdcc_bn_dw_fwd_plan(0, 1, 4, 97, 97, 728, 2, 4) == -1


# pixel counts and widths of the wide 1x1 backward links of a config-#3
# step (4 x 769², Xception-65, OS16) and the card cases above
PLAN_SHAPES = [(4 * 385 * 385, 64, 128), (4 * 385 * 385, 128, 128),
               (4 * 193 * 193, 128, 256), (4 * 193 * 193, 256, 256),
               (4 * 97 * 97, 256, 728), (4 * 97 * 97, 728, 728),
               (4 * 49 * 49, 728, 728), (4 * 49 * 49, 728, 1024),
               (4 * 49 * 49, 1024, 1536), (4 * 49 * 49, 1536, 1536),
               (4 * 49 * 49, 1536, 2048), (97 * 97, 64, 128),
               (25 * 25, 1536, 2048), (2 * 33 * 35, 256, 728), (1, 8, 8),
               (42, 64, 128), (64, 2048, 2048)]


@pytest.mark.parametrize("p,ci,co", PLAN_SHAPES)
def test_wgrad_plan_covers_pixels_in_one_wave(p, ci, co):
    """xpw_wgrad_plan (the Python mirror of the bf16 weight gradient's plan):
    every split holds at least one chunk and together they hold all of them,
    one wave of XPW_CTAS CTAs at most unless one split per tile exceeds it,
    and the tile width follows Ci."""
    bn, tiles, splits, cps = tst.xpw_wgrad_plan(p, ci, co)
    chunks = -(-p // tst.XPW_BK)
    assert bn == (64 if ci <= 64 else 128 if ci <= 128 else 256)
    assert tiles == -(-co // tst.XPW_BM) * -(-ci // bn)
    assert 1 <= splits <= chunks and (splits - 1) * cps < chunks <= splits * cps
    assert splits == 1 or tiles * splits <= tst.XPW_CTAS
    assert splits == 1 or cps >= tst.XPW_MIN_CHUNKS
    floats = tst.xpw_wgrad_scratch_floats(p, ci, co)
    assert floats == (tiles * splits * tst.XPW_BM * bn if splits > 1 else 0)


@pytest.mark.gpu
def test_wgrad_plan_mirrors_the_kernel(cuda):
    for p, ci, co in PLAN_SHAPES:
        assert tst._xpw_grid(tst.XPW_WGRAD, torch.bfloat16, p, ci, co) == \
            tst.xpw_wgrad_plan(p, ci, co)[2], (p, ci, co)


@pytest.mark.gpu
def test_width_guard_routes_and_refuses(cuda):
    x = torch.randn(1, 4, 4, 728, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(1024, 728, device=cuda, dtype=torch.bfloat16)
    before = (tst.run_bn_pw.launches, tst.run_bn_pw_wide.launches)
    tst.run_bn_pw(x, None, w, False)
    assert (tst.run_bn_pw.launches,
            tst.run_bn_pw_wide.launches) == (before[0], before[1] + 1)
    with pytest.raises(ValueError, match="neither"):
        tst.run_bn_pw(torch.randn(1, 4, 4, 724, device=cuda), None,
                      torch.randn(1024, 724, device=cuda), False)


# the bf16 wide forward's plan (xpw_fwd_plan), by hand: BN = 64 / 128 / 256
# by Co, ceil(Co / BN) column blocks, CTAs along x min(ceil(P / 128) pixel
# tiles, 132 // blocks), their moments summed in groups of 12
@pytest.mark.parametrize("p,co,want", [
    (4 * 49 * 49, 728, (256, 44, 3, 4)),
    (4 * 385 * 385, 128, (128, 132, 1, 11)),
    (4 * 49 * 49, 2048, (256, 16, 8, 2)),
    (4 * 97 * 97, 1024, (256, 33, 4, 3)),
    (65, 64, (64, 1, 1, 1)),
])
def test_wide_forward_plan_by_hand(p, co, want):
    assert tst.xpw_fwd_plan(p, co) == want
    assert tst.xpw_fwd_scratch_floats(p, co) == (want[1] + want[3]) * 2 * co


# name: (input NHWC, Co, act, input BN, moments); every geometry of the wide
# forward in a config-#3 step (4 x 769², OS16: the student's train chains
# with moments, the teacher's eval entry blocks without) and the edges:
# ragged pixel tiles, Ci and Co not multiples of 64, relu, no input BN, the
# identity prologue (no BN, no activation), one pixel
_X_FWD = [((4, 385, 385, 64), 128), ((4, 385, 385, 128), 128),
          ((4, 193, 193, 128), 128), ((4, 193, 193, 128), 256),
          ((4, 193, 193, 256), 256), ((4, 97, 97, 256), 256),
          ((4, 97, 97, 256), 728), ((4, 97, 97, 728), 728),
          ((4, 49, 49, 728), 728)]
WIDE_FWD = {
    **{f"step_{s[1]}_{s[3]}_{co}": (s, co, False, True, True)
       for s, co in _X_FWD + [((4, 49, 49, 728), 1024),
                              ((4, 49, 49, 1024), 1024),
                              ((4, 49, 49, 1024), 1536),
                              ((4, 49, 49, 1536), 1536),
                              ((4, 49, 49, 1536), 2048)]},
    **{f"eval_{s[1]}_{s[3]}_{co}": (s, co, False, True, False)
       for s, co in _X_FWD},
    "ragged_200_72_relu": ((1, 3, 7, 200), 72, "relu", True, True),
    "ragged_136_328_eval": ((1, 9, 9, 136), 328, False, True, False),
    "no_bn_relu": ((2, 11, 13, 64), 192, "relu", False, True),
    "identity": ((2, 11, 13, 96), 64, False, False, True),
    "one_pixel": ((1, 1, 1, 64), 64, False, True, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(WIDE_FWD))
def test_wide_forward_matches_plain_on_card(cuda, name, dtype):
    shape, co, act, has_bn, moments = WIDE_FWD[name]
    ci = shape[-1]
    g = torch.Generator(device=cuda).manual_seed(sorted(WIDE_FWD).index(name))
    bn = (torch.stack([0.1 * torch.randn(ci, device=cuda, generator=g),
                       0.5 + torch.rand(ci, device=cuda, generator=g),
                       1 + 0.3 * torch.randn(ci, device=cuda, generator=g),
                       0.2 * torch.randn(ci, device=cuda, generator=g)], 1)
          if has_bn else None)
    x = torch.randn(shape, device=cuda, generator=g).to(dtype)
    w = (torch.randn(co, ci, device=cuda, generator=g) / ci ** 0.5).to(dtype)
    before = tst.run_bn_pw_wide.launches
    got = tst.run_bn_pw_wide(x, bn, w, act, EPS, moments=moments)
    again = tst.run_bn_pw_wide(x, bn, w, act, EPS, moments=moments)
    assert tst.run_bn_pw_wide.launches == before + 2
    y, sums = tst.bn_pw_ref(x, bn, w, act, EPS)
    want = (y, *tst._moments(sums, tst._count(y)))
    torch.cuda.synchronize()
    if not moments:
        assert got[1] is None and got[2] is None
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    for what, a, b, ww in list(zip(("y", "mean", "var"), got, again,
                                   want))[:3 if moments else 1]:
        assert torch.equal(a, b), what
        a, ww = a.float(), ww.float()
        err = float((a - ww).abs().max())
        assert err <= tol * max(float(ww.abs().max()), 1e-6), (what, err)


@pytest.mark.gpu
def test_wide_forward_plan_mirrors_the_kernel(cuda):
    for shape, co, *_ in WIDE_FWD.values():
        p = shape[0] * shape[1] * shape[2]
        assert tst._xpw_grid(tst.XPW_FWD, torch.bfloat16, p, shape[3], co) \
            == tst.xpw_fwd_plan(p, co)[1], (shape, co)
