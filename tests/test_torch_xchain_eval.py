"""The port's Xception eval chains (kd_cheap_conv_tpu_torch.ops.xchain_eval
and the eval guards of models.xception) against the JAX package's.

- (a) Each eval chain's plain version against its JAX counterpart with the
  Pallas kernels in interpret mode, on the same seeded weights and running
  statistics (moved with `state_dict_from_jax`): the middle flow (2 blocks,
  C = 16, 2 x 9 x 11, dilation 1 and 2), the exit flow at the JAX test's
  channels/8 plan (tests/test_pallas_xchain.py:238-239; 2 x 11 x 9,
  dilation 2 and 4), an entry block (16 -> (16, 24, 24), stride 2, as
  tests/test_pallas_xchain.py:518-539, 2 x 11 x 13). f32 within 1e-5 of the
  largest value (both sides round at the same points and sum in other
  orders); bf16 within the pass kernels' 1.6e-2 of it (a last-ulp f32
  difference can round t to bf16 apart).
- (b) The port's Xception-65 backbone (middle trimmed to 2 blocks, 2 x 65²)
  in eval mode under no_grad, through the eval chains, against the JAX
  stock eval path (rtol 2e-4, atol 2e-3, the JAX file's eval tolerance) and
  against its own `_forward_modules` in f64 (1e-9 of the largest value).
- (c) The guards: taken in eval mode without autograd; not with autograd
  on, in train mode, or at OS32's stride-2 exit; taken at OS8 (dilation 2
  and 4, block3 at stride 1 on its modules).
- (d) The fold cache refolds after an in-place change of what it reads,
  for every fold of the port (ops/foldcache.py); the pass wrappers'
  moments=False (the eval entry blocks) gives the same y and no moments.
- (e) `main --test_only --model deeplabv3plus_xception --device cpu`
  reaches the eval chains: 54 folded sep convs per forward.
- (f) the bfloat16 sep conv's two kernels (depthwise pass, product): their
  plain versions composed equal `xsep_eval_ref` bit for bit, f32 and bf16.
- (g) `gpu` cases: the sep conv against its plain version on the card at
  the config-#3 teacher's widths (728 -> 728 with the residual, 728 -> 1024
  with the skip, 1536 -> 2048 with the final relu, the f32 / bf16 input
  and output pairs of a block) and the split's edges (P not a multiple of
  128, the skip with C0 != Ci, f32 in and out at dilation 4), twice, bit
  for bit, with each kernel's launch count; each bf16 kernel alone against
  its plain version; the pass kernels without moments; they skip where
  there is no card.
"""

import contextlib
import functools
import io
import math

import numpy as np
import pytest
import torch
from test_torch_xception import (_materialize, _nchw, _port_backbone, _t,
                                 jax_leaves)

from kd_cheap_conv_tpu_torch.convert import state_dict_from_jax
from kd_cheap_conv_tpu_torch.models.xception import (SepConvBN, Xception65,
                                                     XceptionBlock)
from kd_cheap_conv_tpu_torch.ops import xchain_eval as xe

torch.set_num_threads(1)

CHAIN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
_JNP = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
# the exit flow at channels / 8 (tests/test_pallas_xchain.py:238-239)
_TA = (91, (91, 128, 128))
_TB = ((128, 192), (192, 192), (192, 256))


def _random_stats(jm, seed):
    """Seeded running statistics (mean 0.3 N(0, 1), var 1 + 0.5 U(0, 1))
    for every BN of a JAX module, so that the folds are not near-identity."""
    import jax.numpy as jnp
    from flax import nnx

    rng = np.random.RandomState(seed)
    for _, m in nnx.iter_graph(jm):
        if isinstance(m, nnx.BatchNorm):
            c = m.mean[...].shape[0]
            m.mean[...] = jnp.asarray((0.3 * rng.randn(c)).astype(np.float32))
            m.var[...] = jnp.asarray((1 + 0.5 * rng.rand(c)).astype(
                np.float32))
    return jm


def _pair(jax_ctor, port, seed):
    """(the JAX module jax_ctor() builds, with seeded weights and running
    statistics, in eval mode; `port` with the same state, in eval mode)."""
    from flax import nnx

    jm = _random_stats(_materialize(nnx.eval_shape(jax_ctor), seed), seed)
    jm.eval()
    port.load_state_dict(state_dict_from_jax(jax_leaves(jm)), strict=True)
    return jm, port.eval()


def _modules(kind, d):
    """The JAX and port modules of one chain case (nnx / nn containers
    whose paths match)."""
    import torch.nn as nn
    from flax import nnx

    from kd_cheap_conv_tpu.models import xception as jx

    if kind == "middle":
        class JMid(nnx.Module):
            def __init__(self):
                self.middle = nnx.List([
                    jx.XceptionBlock(16, (16, 16, 16), dilation=d,
                                     rngs=nnx.Rngs(i)) for i in range(2)])

        port = nn.Module()
        port.middle = nn.ModuleList([
            XceptionBlock(16, (16, 16, 16), dilation=d) for _ in range(2)])
        return JMid, port
    if kind == "tail":
        class JTail(nnx.Module):
            def __init__(self):
                r = nnx.Rngs(0)
                self.exit_block = jx.XceptionBlock(*_TA, dilation=d, rngs=r)
                for i, (ci, co) in enumerate(_TB):
                    setattr(self, f"exit_sep{i + 1}", jx.SepConvBN(
                        ci, co, dilation=d, pre_relu=False, post_relu=True,
                        rngs=r))

        port = nn.Module()
        port.exit_block = XceptionBlock(*_TA, dilation=d)
        for i, (ci, co) in enumerate(_TB):
            setattr(port, f"exit_sep{i + 1}", SepConvBN(
                ci, co, dilation=d, pre_relu=False, post_relu=True))
        return JTail, port

    class JEntry(nnx.Module):
        def __init__(self):
            self.blk = jx.XceptionBlock(16, (16, 24, 24), stride=2,
                                        rngs=nnx.Rngs(7))

    port = nn.Module()
    port.blk = XceptionBlock(16, (16, 24, 24), stride=2)
    return JEntry, port


# name: (chain, input NHWC, dilation)
CHAINS = {"middle_d1": ("middle", (2, 9, 11, 16), 1),
          "middle_d2": ("middle", (2, 9, 11, 16), 2),
          "tail_d2": ("tail", (2, 11, 9, 91), 2),
          "tail_d4": ("tail", (2, 11, 9, 91), 4),
          "entry": ("entry", (2, 11, 13, 16), 1)}


@functools.cache
def _chain_pair(name):
    kind, _, d = CHAINS[name]
    jctor, port = _modules(kind, d)
    return _pair(jctor, port, sorted(CHAINS).index(name))


def _jax_tail_eval(xj, eb, seps, d):
    """JAX `fused_x_tail_eval` (xchain.py:840-866), its two `_run_seg_eval`
    kernels in interpret mode, on a folded buffer with 3 * d spare rows. Its
    own buffer (`_geom`: one row block of slack) is too short at bh = 4 and
    dilation 2: the last row block's halo window (bh + 6 d rows) ends past
    it, interpret mode clamps the window's start, and rows from the third
    on come out 4e-3 of the largest value off at 2 x 11 x 9 (ROADMAP.md
    Queue 3). The spare rows change nothing else."""
    import jax
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas import xchain as jxc

    n, h, w, _ = xj.shape
    bh = jxc.BH_XE_TAIL
    rows = jxc._geom(h, bh)[1] + bh * -(-3 * d // bh)
    sk = eb.skip_bn
    ssk = sk.scale[...] * jax.lax.rsqrt(sk.var[...] + sk.epsilon)
    wsk = eb.skip_conv.kernel[...][0, 0].T.astype(jnp.float32)
    skip = ((ssk[:, None] * wsk).astype(xj.dtype),
            (sk.bias[...] - sk.mean[...] * ssk)[:, None])
    z = jxc._run_seg_eval(jxc._fold(xj, rows), (eb.sep1, eb.sep2, eb.sep3),
                          d, (True,) * 3, skip, False, h, n * w, w, xj.dtype,
                          True, bh)
    z = jxc._run_seg_eval(z, tuple(seps), d, (False, True, True), None, True,
                          h, n * w, w, xj.dtype, True, bh)
    return jxc._unfold(z, n, h, w)


def _run_chain(name, jm, pm, x, dtype):
    """(the port's plain chain, the JAX chain in interpret mode) on x."""
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas import xchain as jxc

    kind, _, d = CHAINS[name]
    xj = jnp.asarray(x).astype(_JNP[dtype])
    xt = _t(x).to(dtype)
    # the port's modules compute in x's dtype, as a --bf16 model's do (the
    # entry block's skip runs on them)
    for m in pm.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = None if dtype == torch.float32 else dtype
    with torch.no_grad():
        if kind == "middle":
            got = xe.fused_x_middle_eval(xt, pm.middle, d)
            want = jxc.fused_x_middle_eval(xj, list(jm.middle), True, dil=d)
        elif kind == "tail":
            seps = [getattr(pm, f"exit_sep{i}") for i in (1, 2, 3)]
            jseps = [getattr(jm, f"exit_sep{i}") for i in (1, 2, 3)]
            got = xe.fused_x_tail_eval(xt, pm.exit_block, seps, d)
            want = _jax_tail_eval(xj, jm.exit_block, jseps, d)
        else:
            got = xe.fused_x_entry_block_eval(xt, pm.blk)
            want = jxc.fused_x_entry_block_eval(xj, jm.blk, True)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CHAINS))
def test_eval_chain_matches_jax_interpret(name, dtype):
    jm, pm = _chain_pair(name)
    x = np.random.RandomState(11).randn(*CHAINS[name][1]).astype(np.float32)
    got, want = _run_chain(name, jm, pm, x, dtype)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= CHAIN_TOL[dtype] * scale, (err, scale)


# ---------------------------------------------------------------------------
# (b) the backbone
# ---------------------------------------------------------------------------

@functools.cache
def _backbone_eval():
    """The JAX Xception65 (middle trimmed to 2 blocks, seeded weights and
    running statistics) on its stock eval path: (leaves, x, out,
    low_level)."""
    import jax.numpy as jnp
    from flax import nnx

    from kd_cheap_conv_tpu.models.xception import Xception65 as JaxXception65

    ab = nnx.eval_shape(lambda: JaxXception65(output_stride=16,
                                              rngs=nnx.Rngs(0)))
    ab.middle = nnx.List([ab.middle[0], ab.middle[1]])
    jm = _random_stats(_materialize(ab, 5), 5)
    jm.eval()
    x = np.random.RandomState(44).randn(2, 65, 65, 3).astype(np.float32)
    o = nnx.jit(lambda m, x: m(x))(jm, jnp.asarray(x))
    return (jax_leaves(jm), x, np.asarray(o["out"]),
            np.asarray(o["low_level"]))


def _count_eval_calls(monkeypatch):
    calls = dict.fromkeys(("xsep", "pw", "dw", "dw_s2"), 0)
    for name, key in (("run_xsep_eval", "xsep"), ("run_bn_pw", "pw"),
                      ("run_bn_dw", "dw"), ("run_bn_dw_s2", "dw_s2")):
        orig = getattr(xe, name)

        def spy(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(xe, name, spy)
    return calls


def test_backbone_eval_matches_jax_stock_and_f64_modules(monkeypatch):
    leaves, x, out, low = _backbone_eval()
    m = _port_backbone(leaves).eval()
    calls = _count_eval_calls(monkeypatch)
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        o = m(xt)
    # 3 entry blocks (3 1x1, 2 depthwise, 1 stride-2 depthwise each), 2
    # middle blocks and the exit flow (3 + 3 folded sep convs)
    assert calls == {"xsep": 2 * 3 + 6, "pw": 9, "dw": 6, "dw_s2": 3}
    for name, got, want in (("out", o["out"], out),
                            ("low_level", o["low_level"], low)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=2e-4, atol=2e-3, err_msg=name)
    f64 = torch.float64
    m64 = _port_backbone(leaves, f64).eval()
    x64 = xt.to(f64)
    with torch.no_grad():
        oc, om = m64(x64), m64._forward_modules(x64)
    assert calls["xsep"] == 2 * 12
    for k in ("out", "low_level"):
        scale = float(om[k].abs().max())
        assert float((oc[k] - om[k]).abs().max()) <= 1e-9 * scale, k


# ---------------------------------------------------------------------------
# (c) the guards
# ---------------------------------------------------------------------------

def _eval_guards(m):
    return ([m._fused_entry_eval_ok(b) for b in (m.block1, m.block2,
                                                 m.block3)],
            m._fused_middle_eval_active(), m._fused_tail_eval_active())


def _meta_xception(os):
    """An Xception65 without storage: the guards read structure only."""
    with torch.device("meta"):
        return Xception65(output_stride=os).eval()


def test_eval_guards():
    m = _meta_xception(16)
    with torch.no_grad():
        assert _eval_guards(m) == ([True] * 3, True, True)
    # autograd on: the module path (the chains are forward-only)
    assert _eval_guards(m) == ([False] * 3, False, False)
    m.train()
    with torch.no_grad():
        assert _eval_guards(m) == ([False] * 3, False, False)
        assert m._fused_middle_active() and m._fused_tail_active()
    # one BN in train mode refuses its segment
    m.eval()
    m.middle[3].sep2.bn.train()
    m.exit_sep2.sep.bn_dw.train()
    with torch.no_grad():
        assert _eval_guards(m) == ([True] * 3, False, False)
    m32 = _meta_xception(32)
    with torch.no_grad():
        # OS32's exit runs stride 2 on its modules
        assert _eval_guards(m32) == ([True] * 3, True, False)
    m8 = _meta_xception(8)
    with torch.no_grad():
        # block3 at stride 1 stays on its modules; middle d 2, exit d 4
        assert _eval_guards(m8) == ([True, True, False], True, True)


def test_eval_forward_with_autograd_runs_modules(monkeypatch):
    leaves, x = _backbone_eval()[:2]
    m = _port_backbone(leaves).eval()
    calls = _count_eval_calls(monkeypatch)
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    o = m(xt)
    assert o["out"].requires_grad
    assert calls == dict.fromkeys(calls, 0)
    with torch.no_grad():
        want = m._forward_modules(xt)
    assert torch.equal(o["out"].detach(), want["out"])


# ---------------------------------------------------------------------------
# (d) the fold cache
# ---------------------------------------------------------------------------

def test_fold_cache_refolds_after_in_place_change():
    blk = XceptionBlock(16, (16, 24, 24), stride=2).eval()
    s = blk.sep2
    f = xe.fold_sep_eval(s, torch.float32)
    assert xe.fold_sep_eval(s, torch.float32) is f
    assert xe.fold_sep_eval(s, torch.bfloat16).w.dtype == torch.bfloat16
    with torch.no_grad():
        s.sep.pointwise.weight.mul_(2.0)
    g = xe.fold_sep_eval(s, torch.float32)
    assert g is not f
    torch.testing.assert_close(g.w, 2 * f.w)
    with torch.no_grad():
        s.bn.running_var.add_(1.0)
    h = xe.fold_sep_eval(s, torch.float32)
    assert h is not g and not torch.equal(h.w, g.w)
    k = xe.fold_skip_eval(blk, torch.float32)
    with torch.no_grad():
        blk.skip_bn.running_mean.add_(0.5)
    assert not torch.equal(xe.fold_skip_eval(blk, torch.float32).b, k.b)
    e = xe.entry_eval_params(blk, torch.float32)
    assert xe.entry_eval_params(blk, torch.float32) is e
    k = e[0][0].clone()
    with torch.no_grad():
        blk.sep1.sep.depthwise.weight.neg_()
    e2 = xe.entry_eval_params(blk, torch.float32)
    assert e2 is not e
    torch.testing.assert_close(e2[0][0], -k)



def _fold_case(kind):
    """(module, fold(dtype), a tensor the fold reads) of one of the port's
    four folds, all cached by ops/foldcache.py."""
    from kd_cheap_conv_tpu_torch.models.mobilenetv2 import InvertedResidual
    from kd_cheap_conv_tpu_torch.models.resnet import Bottleneck
    from kd_cheap_conv_tpu_torch.ops import irchain_eval as ire
    from kd_cheap_conv_tpu_torch.ops import rchain as trc
    from kd_cheap_conv_tpu_torch.ops import tstem as tts

    if kind == "tstem":
        conv = torch.nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        bn = torch.nn.BatchNorm2d(64).eval()
        return conv, lambda dt: tts.fold_stem(conv, bn, dt), bn.running_var
    if kind == "bneck":
        blk = Bottleneck(64, 16).eval()
        return (blk, lambda dt: trc.fold_bneck_eval(blk, dt),
                blk.bn2.running_var)
    if kind == "ir":
        blk = InvertedResidual(16, 16, expand_ratio=6).eval()
        return (blk, lambda dt: ire.fold_ir_eval(blk, dt),
                blk.pw_bn.running_var)
    s = XceptionBlock(16, (16, 24, 24), stride=2).eval().sep1
    return s, lambda dt: xe.fold_sep_eval(s, dt), s.bn.running_var


@pytest.mark.parametrize("kind", ["tstem", "bneck", "ir", "xsep"])
def test_every_fold_follows_the_shared_cache_rule(kind):
    """Each fold is kept until a tensor it reads is updated in place or
    replaced, and per dtype (ops/foldcache.py)."""
    _, fold, t = _fold_case(kind)
    f = fold(torch.float32)
    assert fold(torch.float32) is f
    b = fold(torch.bfloat16)
    assert b is not f and fold(torch.bfloat16) is b
    with torch.no_grad():
        t.mul_(4.0)
    g = fold(torch.float32)
    assert g is not f and fold(torch.float32) is g
    t.data = t.data.clone()           # replaced: a new data pointer
    assert fold(torch.float32) is not g


def _pass_case(kind, dev, g):
    """A pass wrapper's positional arguments (eval entry block widths) and
    the wrapper."""
    from kd_cheap_conv_tpu_torch.ops import stem as tst

    c, co = (16, 24) if kind != "pw_wide" else (728, 728)
    x = torch.randn(2, 9, 11, c, generator=g).to(dev)
    pack = tst._bn_pack(0.3 * torch.randn(c, generator=g),
                        1 + torch.rand(c, generator=g),
                        1 + 0.2 * torch.randn(c, generator=g),
                        0.1 * torch.randn(c, generator=g)).to(dev)
    if kind.startswith("pw"):
        w = (torch.randn(co, c, generator=g) / c ** 0.5).to(dev)
        return tst.run_bn_pw, (x, pack, w, False)
    k = (torch.randn(c, 9, generator=g) / 3).to(dev)
    fn = tst.run_bn_dw if kind == "dw" else tst.run_bn_dw_s2
    return fn, (x, pack, k, "relu")


@pytest.mark.parametrize("kind", ["pw", "dw", "dw_s2"])
def test_eval_passes_take_no_moments(kind):
    """moments=False (the eval entry blocks) gives the same y and no
    moments."""
    fn, args = _pass_case(kind, "cpu", torch.Generator().manual_seed(3))
    y, m, v = fn(*args)
    y0, m0, v0 = fn(*args, moments=False)
    assert torch.equal(y0, y) and m0 is None and v0 is None
    assert m is not None and v is not None


# ---------------------------------------------------------------------------
# (e) the serving command
# ---------------------------------------------------------------------------

def test_main_test_only_xception_reaches_eval_chains(monkeypatch):
    from kd_cheap_conv_tpu_torch import main as port_main

    calls = _count_eval_calls(monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_main.main(["--test_only", "--dataset", "synthetic",
                             "--model", "deeplabv3plus_xception", "--kd",
                             "--replace_scope", "classifier", "--device",
                             "cpu", "--crop_size", "33", "--num_classes",
                             "19", "--val_batch_size", "16",
                             "--num_workers", "2"])
    assert rc == 0
    miou = float(out.getvalue().split("Mean IoU:")[1].split()[0])
    assert math.isfinite(miou)
    forwards = 2                      # 32 val images in batches of 16
    assert calls == {"xsep": 54 * forwards, "pw": 9 * forwards,
                     "dw": 6 * forwards, "dw_s2": 3 * forwards}


# ---------------------------------------------------------------------------
# (f) the bfloat16 split, (g) the kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# name: (input NHWC, Co, dilation, pre-relu, residual ("x0" or skip width
# or None), final relu, input dtype is f32, output dtype is f32)
CARD = {
    "mid_conv1": ((2, 9, 11, 728), 728, 1, True, None, False, False, True),
    "mid_conv2": ((2, 9, 11, 728), 728, 1, True, None, False, True, True),
    "mid_conv3_res": ((2, 9, 11, 728), 728, 1, True, "x0", False, True,
                      False),
    "exit_skip_d2": ((2, 7, 9, 1024), 1024, 2, True, 728, False, True,
                     False),
    "exit_sep1_d2": ((2, 7, 9, 1024), 1536, 2, False, None, False, False,
                     True),
    "exit_sep3_relu_d4": ((1, 13, 10, 1536), 2048, 4, True, None, True,
                          True, False),
}
# the bfloat16 split's edges: P not a multiple of the product's 128-row
# tile with Ci and Co not multiples of 64, the skip with C0 != Ci and an
# f32 output, f32 in and out at dilation 4
CARD_SPLIT = {
    "ragged_p_728_res": ((1, 13, 11, 728), 728, 1, True, "x0", False, True,
                         False),
    "skip_c0_ne_ci_f32_out": ((2, 5, 7, 1024), 1024, 2, True, 728, False,
                              True, True),
    "f32_in_out_d4": ((1, 9, 10, 728), 1024, 4, True, None, True, True,
                      True),
}
CASES = {**CARD, **CARD_SPLIT}


def _card_args(name, dtype, dev):
    shape, co, dil, pre, res, relu, in32, out32 = CASES[name]
    seed = (sorted(CARD).index(name) if name in CARD
            else len(CARD) + sorted(CARD_SPLIT).index(name))
    g = torch.Generator().manual_seed(seed)
    n, h, w, ci = shape

    def randn(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=g)).to(dev)

    f32 = torch.float32
    x = randn(*shape).to(f32 if in32 else dtype)
    taps, wt = randn(9, ci, scale=0.3), randn(co, ci, scale=ci ** -0.5)
    kw = {"dil": dil, "pre_relu": pre, "final_relu": relu,
          "out_dtype": f32 if out32 else dtype}
    if res == "x0":
        kw["x0"] = randn(n, h, w, co).to(dtype)
    elif res is not None:
        kw.update(x0=randn(n, h, w, res).to(dtype),
                  wsk=randn(co, res, scale=res ** -0.5).to(dtype),
                  bsk=randn(co, scale=0.1))
    return (x, taps, wt.to(dtype), randn(co, scale=0.1)), kw


def _split_ref(args, kw):
    """The split's plain versions composed: the depthwise pass's t (rounded
    to w's dtype), then the product."""
    x, taps, w, b = args
    rest = {k: v for k, v in kw.items() if k not in ("dil", "pre_relu")}
    t = xe.xsep_dw_ref(x, taps, dil=kw["dil"], pre_relu=kw["pre_relu"],
                       dtype=w.dtype)
    return xe.xsep_mm_ref(t, w, b, **rest)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CARD))
def test_split_plain_versions_compose_to_xsep_eval_ref(name, dtype):
    """The bfloat16 path's two kernels change no rounding point: their
    plain versions composed give xsep_eval_ref bit for bit (f32 too)."""
    args, kw = _card_args(name, dtype, "cpu")
    assert torch.equal(_split_ref(args, kw), xe.xsep_eval_ref(*args, **kw))


def _counts():
    return (xe.run_xsep_eval.launches, xe.run_xsep_dw.launches,
            xe.run_xsep_mm.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CASES))
def test_xsep_kernel_matches_plain_on_card(cuda, name, dtype):
    """bfloat16: the depthwise pass and the product, one launch each per
    call and none of the float32 kernel; float32: that kernel alone."""
    args, kw = _card_args(name, dtype, cuda)
    before = _counts()
    got = xe.run_xsep_eval(*args, **kw)
    again = xe.run_xsep_eval(*args, **kw)
    per_call = (1, 0, 0) if dtype == torch.float32 else (0, 1, 1)
    assert _counts() == tuple(b + 2 * p for b, p in zip(before, per_call))
    want = xe.xsep_eval_ref(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, again)
    err = float((got.float() - want.float()).abs().max())
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    assert err <= tol * float(want.float().abs().max()), err


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_split_kernels_match_their_plain_versions_on_card(cuda, name):
    """Each bfloat16 kernel alone against its plain version on the same
    inputs (t: one bf16 rounding of sums in another order apart), twice
    bit for bit."""
    (x, taps, w, b), kw = _card_args(name, torch.bfloat16, cuda)
    t = xe.run_xsep_dw(x, taps, dil=kw["dil"], pre_relu=kw["pre_relu"])
    t_want = xe.xsep_dw_ref(x, taps, dil=kw["dil"], pre_relu=kw["pre_relu"])
    rest = {k: v for k, v in kw.items() if k not in ("dil", "pre_relu")}
    y = xe.run_xsep_mm(t_want, w, b, **rest)
    y_want = xe.xsep_mm_ref(t_want, w, b, **rest)
    again = (xe.run_xsep_dw(x, taps, dil=kw["dil"], pre_relu=kw["pre_relu"]),
             xe.run_xsep_mm(t_want, w, b, **rest))
    torch.cuda.synchronize()
    assert torch.equal(t, again[0]) and torch.equal(y, again[1])
    for got, want in ((t, t_want), (y, y_want)):
        err = float((got.float() - want.float()).abs().max())
        assert err <= 1.6e-2 * float(want.float().abs().max()), err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["pw", "pw_wide", "dw", "dw_s2"])
def test_eval_passes_without_moments_on_card(cuda, kind, dtype):
    """The pass kernels with a null partial pointer: y bit for bit the
    moments run's, one launch each, no moments."""
    fn, args = _pass_case(kind, cuda, torch.Generator().manual_seed(3))
    args = (args[0].to(dtype), args[1],
            args[2].to(dtype) if kind.startswith("pw") else args[2], args[3])
    y, _, _ = fn(*args)
    y0, m0, v0 = fn(*args, moments=False)
    torch.cuda.synchronize()
    assert torch.equal(y0, y) and m0 is None and v0 is None
