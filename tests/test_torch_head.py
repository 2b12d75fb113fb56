"""The port's head kernels (kd_cheap_conv_tpu_torch.ops.separable and
ops.decoder) against the JAX package's, whose Pallas kernels run in
interpret mode on the CPU.

- (a) `fused_separable_conv` (its plain version) against the JAX
  `fused_separable_conv(..., interpret=True)` at 2x9x11x16 -> 24, dilation
  1, 2, 3, f32: values rtol = atol = 1e-4, the gradients of x, dw and pw
  rtol 2e-3, atol 2e-4 (tests/test_pallas_decoder.py's); in bf16 the
  plain version within one bf16 ulp of the JAX kernel's output.
- (b) `fused_decoder_head` against the JAX `fused_decoder_head_folded` at
  2x17x19x(8 + 16), Cm 48, 5 classes, f32: logits 1e-4, (mean, var) rtol
  1e-4 / atol 1e-5, g_low and g_up rtol 2e-3 / atol 2e-4 and every
  parameter gradient 2e-3 / 2e-3 (the JAX test's tolerances).
- (c) Each plain pass (`sep_fwd_ref`, `head_fwd_ref`, `head_bwd_ref`,
  `sep_bwd_ref`) against its own torch-autograd composition, f64.
- (d) The port's train-mode `deeplabv3plus_mobilenet` (separable-converted
  head, 33², 6 classes) against the JAX one with `use_pallas_decoder` on:
  the loss, the head's gradients (within 3x the port's own f32 error
  against f64, as tests/test_torch_train.py holds the KD step), the
  backbone's (against an f64 run of the JAX student: the port's f64
  gradient to relative L2 1e-6, its f32 gradient within 3x its own f32
  error; the JAX f32 run beside them at 5e-2) and the running
  statistics of the fuse BN and the ASPP BNs; the plain decoder passes are counted, so the test cannot pass on the
  module path. The JAX ASPP branches run stock there (its separable kernel
  runs only in interpret mode on the CPU, and the module does not ask for
  it), so the port's separable plain version is held to them in f32.
- (e) The guard: hint taps, eval mode and a dense fuse conv leave the fused
  head untaken.

The `gpu` cases compare each CUDA kernel with its plain version on the card
and skip where there is none; JAX is imported inside the JAX-side helpers.
Among them: the separable conv at config #2's and config #3's ASPP shapes
and the serving fuse conv, and P1 at config #2's and config #3's full
shapes, each twice bit for bit; the refusals of the kernels' plans.
"""

import copy
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kd_cheap_conv_tpu_torch.ops import decoder as tdec
from kd_cheap_conv_tpu_torch.ops import dwconv as tdw
from kd_cheap_conv_tpu_torch.ops import separable as tsep
from kd_cheap_conv_tpu_torch.ops import stem as tst
from kd_cheap_conv_tpu_torch.ops import upsample as tup

torch.set_num_threads(1)

EPS = 1e-5
VAL = dict(rtol=1e-4, atol=1e-4)
SUM = dict(rtol=1e-4, atol=1e-5)
DX = dict(rtol=2e-3, atol=2e-4)
DP = dict(rtol=2e-3, atol=2e-3)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


# ---------------------------------------------------------------------------
# (a) the separable conv
# ---------------------------------------------------------------------------

def _sep_data(dil, seed=0):
    rng = np.random.RandomState(seed + dil)
    return (rng.randn(2, 9, 11, 16).astype(np.float32),
            (0.4 * rng.randn(3, 3, 1, 16)).astype(np.float32),    # HWIO
            (0.2 * rng.randn(1, 1, 16, 24)).astype(np.float32),
            rng.randn(2, 9, 11, 24).astype(np.float32))


@functools.cache
def _jax_sep(dil):
    import jax
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas.separable import fused_separable_conv

    x, dw, pw, cot = (jnp.asarray(v) for v in _sep_data(dil))

    def loss(x, dw, pw):
        return jnp.sum(fused_separable_conv(x, dw, pw, dil, None, True) * cot)

    y = fused_separable_conv(x, dw, pw, dil, None, True)
    grads = jax.grad(loss, argnums=(0, 1, 2))(x, dw, pw)
    return np.asarray(y), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("dil", [1, 2, 3])
def test_separable_matches_jax_kernel(dil):
    x, dw, pw, cot = _sep_data(dil)
    want_y, (want_gx, want_gdw, want_gpw) = _jax_sep(dil)
    tx = _t(x).requires_grad_()
    tdw = _t(dw.transpose(3, 2, 0, 1)).requires_grad_()     # (C, 1, 3, 3)
    tpw = _t(pw.transpose(3, 2, 0, 1)).requires_grad_()     # (Co, C, 1, 1)
    y = tsep.fused_separable_conv(tx, tdw, tpw, dil)
    assert y.shape == want_y.shape
    np.testing.assert_allclose(y.detach().numpy(), want_y, **VAL)
    (y * _t(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want_gx, err_msg="dx", **DX)
    np.testing.assert_allclose(tdw.grad.numpy(),
                               want_gdw.transpose(3, 2, 0, 1), err_msg="ddw",
                               **DX)
    np.testing.assert_allclose(tpw.grad.numpy(),
                               want_gpw.transpose(3, 2, 0, 1), err_msg="dpw",
                               **DX)


def _bf16_ulp(v):
    """One bf16 ulp at magnitude v (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@functools.cache
def _jax_sep_bf16(dil):
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas.separable import fused_separable_conv

    x, dw, pw, _ = (jnp.asarray(v).astype(jnp.bfloat16)
                    for v in _sep_data(dil))
    y = fused_separable_conv(x, dw, pw, dil, None, True)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("dil", [1, 2, 3])
def test_separable_bf16_matches_jax_kernel(dil):
    """bf16 x, dw and pw: the plain version rounds where the JAX kernel
    does (the depthwise output kept in f32 for the pointwise product, y
    rounded once), so the two agree within one bf16 ulp of the output."""
    x, dw, pw, _ = _sep_data(dil)
    want = _jax_sep_bf16(dil)
    bf = torch.bfloat16
    y = tsep.separable_ref(_t(x).to(bf), _t(dw.transpose(3, 2, 0, 1)).to(bf),
                           _t(pw.transpose(3, 2, 0, 1)).to(bf), dil)
    assert y.dtype == bf and y.shape == want.shape
    err = float(np.abs(y.float().numpy() - want).max())
    assert err <= _bf16_ulp(float(np.abs(want).max())), err


@pytest.mark.parametrize("kw,ok", [
    (dict(stride=1, padding=6, dilation=6, kernel_size=3), True),
    (dict(stride=(1, 1), padding=(2, 2), dilation=(1, 1),
          kernel_size=(5, 5)), True),
    (dict(stride=2, padding=1, dilation=1, kernel_size=3), False),
    (dict(stride=1, padding=0, dilation=1, kernel_size=3), False),
    (dict(stride=1, padding=(1, 2), dilation=(1, 2), kernel_size=3), False),
    (dict(stride=1, padding=1, dilation=1, kernel_size=(3, 1)), False),
    (dict(stride=1, padding=1, dilation=1, kernel_size=2), False)])
def test_supports_fused_separable(kw, ok):
    assert tsep.supports_fused_separable(**kw) is ok


# ---------------------------------------------------------------------------
# (b) the decoder head
# ---------------------------------------------------------------------------

def _head_data(seed=3, shape=(2, 17, 19), cl=8, cu=16, nc=5):
    rng = np.random.RandomState(seed)
    ci = cl + cu
    cm = 2 * ci
    p = {"k": (0.4 * rng.randn(ci, 9)).astype(np.float32),
         "pw": (0.2 * rng.randn(cm, ci)).astype(np.float32),
         "g": (1 + 0.2 * rng.randn(cm)).astype(np.float32),
         "b": (0.1 * rng.randn(cm)).astype(np.float32),
         "wc": (0.3 * rng.randn(nc, cm)).astype(np.float32),
         "bc": (0.1 * rng.randn(nc)).astype(np.float32)}
    x = rng.randn(*shape, ci).astype(np.float32)
    cot = rng.randn(*shape, nc).astype(np.float32)
    return x[..., :cl], x[..., cl:], p, cot


@functools.cache
def _jax_head():
    import jax
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas.decoder import fused_decoder_head_folded

    low, up, p, cot = _head_data()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    args = (jnp.asarray(low), jnp.asarray(up), jp)

    def loss(low, up, p):
        y, _ = fused_decoder_head_folded(low, up, p, EPS, True)
        return jnp.sum(y * cot)

    y, (m, v) = fused_decoder_head_folded(*args, EPS, True)
    val, (gl, gu, gp) = jax.value_and_grad(loss, argnums=(0, 1, 2))(*args)
    return (np.asarray(y), np.asarray(m), np.asarray(v), float(val),
            np.asarray(gl), np.asarray(gu),
            {k: np.asarray(g) for k, g in gp.items()})


def test_decoder_head_matches_jax_kernel():
    low, up, p, cot = _head_data()
    y_w, m_w, v_w, val_w, gl_w, gu_w, gp_w = _jax_head()
    tl, tu = _t(low).requires_grad_(), _t(up).requires_grad_()
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    y, (m, v) = tdec.fused_decoder_head(tl, tu, tp, EPS)
    assert y.shape == y_w.shape == (2, 17, 19, 5)
    np.testing.assert_allclose(y.detach().numpy(), y_w, **VAL)
    np.testing.assert_allclose(m.numpy(), m_w, err_msg="mean", **SUM)
    np.testing.assert_allclose(v.numpy(), v_w, err_msg="var", **SUM)
    loss = (y * _t(cot)).sum()
    np.testing.assert_allclose(float(loss.detach()), val_w, rtol=1e-4)
    loss.backward()
    np.testing.assert_allclose(tl.grad.numpy(), gl_w, err_msg="g_low", **DX)
    np.testing.assert_allclose(tu.grad.numpy(), gu_w, err_msg="g_up", **DX)
    for k in tdec.HEAD_KEYS:
        np.testing.assert_allclose(tp[k].grad.numpy(), gp_w[k],
                                   err_msg=f"d {k}", **DP)


# ---------------------------------------------------------------------------
# (c) each plain pass against its torch-autograd composition
# ---------------------------------------------------------------------------

def _pass_data(seed=4, n=2, h=7, w=9, cl=8, cu=16, cm=32, nc=5):
    g = torch.Generator().manual_seed(seed)

    def randn(*s, scale=1.0):
        return scale * torch.randn(s, generator=g, dtype=torch.float64)

    ci = cl + cu
    return {"low": randn(n, h, w, cl), "up": randn(n, h, w, cu),
            "k": randn(ci, 9, scale=0.4), "pw": randn(cm, ci, scale=0.2),
            "g": 1 + randn(cm, scale=0.2), "b": randn(cm, scale=0.1),
            "wc": randn(nc, cm, scale=0.3), "bc": randn(nc, scale=0.1),
            "gl": randn(n, h, w, nc)}


def _compose_a(d):
    x = torch.cat([d["low"], d["up"]], -1).permute(0, 3, 1, 2)
    ci = x.shape[1]
    t = F.conv2d(x, d["k"].reshape(ci, 1, 3, 3), None, 1, 1, 1, ci)
    return F.conv2d(t, d["pw"][:, :, None, None]).permute(0, 2, 3, 1)


def _batch_bn(a):
    m = a.mean((0, 1, 2))
    return m, (a * a).mean((0, 1, 2)) - m * m


@pytest.mark.parametrize("name", ["sep_fwd", "head_fwd", "head_bwd",
                                  "sep_bwd"])
def test_plain_pass_matches_autograd(name):
    d = _pass_data()
    a = _compose_a(d)
    m, v = _batch_bn(a)
    bn = tst._bn_pack(m, v, d["g"], d["b"])
    tol = dict(rtol=1e-9, atol=1e-9)
    if name == "sep_fwd":
        got, sums = tdec.sep_fwd_ref(d["low"], d["up"], d["k"], d["pw"])
        np.testing.assert_allclose(got.numpy(), a.numpy(), **tol)
        gm, gv = tst._moments(sums, tst._count(got))
        np.testing.assert_allclose(gm.numpy(), m.numpy(), **tol)
        np.testing.assert_allclose(gv.numpy(), v.numpy(), **tol)
        return
    if name == "head_fwd":
        want = (torch.relu((a - m) / torch.sqrt(v + EPS) * d["g"] + d["b"])
                @ d["wc"].t() + d["bc"])
        got = tdec.head_fwd_ref(a, bn, d["wc"], d["bc"])
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
        return
    if name == "head_bwd":
        u = ((a - m) / torch.sqrt(v + EPS) * d["g"] + d["b"]) \
            .requires_grad_()
        wc, bc = (d[k].clone().requires_grad_() for k in ("wc", "bc"))
        ((torch.relu(u) @ wc.t() + bc) * d["gl"]).sum().backward()
        gu, sums, dwc, dbc = tdec.head_bwd_ref(d["gl"], a, bn, d["wc"])
        xh = (a - m) / torch.sqrt(v + EPS)
        np.testing.assert_allclose(gu.numpy(), u.grad.numpy(), **tol)
        np.testing.assert_allclose(
            sums.numpy(), torch.stack([u.grad.sum((0, 1, 2)),
                                       (u.grad * xh).sum((0, 1, 2))],
                                      1).numpy(), **tol)
        np.testing.assert_allclose(dwc.numpy(), wc.grad.numpy(), **tol)
        np.testing.assert_allclose(dbc.numpy(), bc.grad.numpy(), **tol)
        return
    # sep_bwd: ga is the train-BN backward of gu, so the pass equals
    # autograd through a = pw(dw(cat(low, up))) and a batch-stat BN
    lead = {k: d[k].clone().requires_grad_() for k in ("low", "up", "k",
                                                        "pw")}
    a2 = _compose_a(lead)
    m2, v2 = _batch_bn(a2)
    xh = (a2 - m2) / torch.sqrt(v2 + EPS)
    gu = torch.randn(a.shape, generator=torch.Generator().manual_seed(9),
                     dtype=torch.float64)
    (xh * d["g"] * gu).sum().backward()
    xhd = xh.detach()
    pn = tst._bnbwd_pack(m, v, d["g"], gu.sum((0, 1, 2)),
                         (gu * xhd).sum((0, 1, 2)), float(tst._count(a)))
    g_low, g_up, dpw, dk = tdec.sep_bwd_ref(gu, a, d["low"], d["up"], pn,
                                            d["k"], d["pw"])
    tol = dict(rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(g_low.numpy(), lead["low"].grad.numpy(), **tol)
    np.testing.assert_allclose(g_up.numpy(), lead["up"].grad.numpy(), **tol)
    np.testing.assert_allclose(dpw.numpy(), lead["pw"].grad.numpy(), **tol)
    np.testing.assert_allclose(dk.numpy(), lead["k"].grad.numpy(), **tol)


# ---------------------------------------------------------------------------
# (d) the model, (e) the guard
# ---------------------------------------------------------------------------

def _jax_flat(state):
    from flax import nnx

    return {".".join(map(str, p)): np.asarray(v[...])
            for p, v in nnx.to_flat_state(state)}


@functools.cache
def _jax_student(seed=11, n=2):
    """(leaves before, input, labels, loss, grads, batch statistics after)
    of the JAX student's train-mode forward + backward with the fused
    decoder head on (interpret mode)."""
    import jax
    import jax.numpy as jnp
    from flax import nnx

    from kd_cheap_conv_tpu import config
    from kd_cheap_conv_tpu.kd.replace import CheapConvSpec, replace_cheap_convs
    from kd_cheap_conv_tpu.models import build_model

    jm = nnx.jit(lambda: build_model("deeplabv3plus_mobilenet", 6, 16,
                                     rngs=nnx.Rngs(0)))()
    replace_cheap_convs(jm, CheapConvSpec(kind="separable"),
                        scope="classifier", rngs=nnx.Rngs(1))
    jm.classifier.aspp.dropout.rate = 0.0
    before = _jax_flat(nnx.state(jm, nnx.Any(nnx.Param, nnx.BatchStat)))
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 33, 33, 3).astype(np.float32)
    labels = rng.randint(0, 6, (n, 33, 33))

    def loss(model, x):
        logits = model(x)
        return jnp.mean((logits.astype(jnp.float32)
                         - jax.nn.one_hot(labels, 6)) ** 2)

    old = config.use_pallas_decoder
    try:
        config.use_pallas_decoder = True
        assert jm.classifier._fused_head_active(False)
        val, grads = nnx.jit(nnx.value_and_grad(loss))(jm, jnp.asarray(x))
    finally:
        config.use_pallas_decoder = old
    after = _jax_flat(nnx.state(jm, nnx.BatchStat))
    return before, x, labels, float(val), _jax_flat(grads), after


@functools.cache
def _jax_student64(seed=11, n=4, switches=()):
    """The `_jax_student` run in float64: built as there, every leaf cast to
    float64 under jax.enable_x64, the input float64, with the config
    switches named in `switches` on (their Pallas kernels, in interpret
    mode, compute in float32 inside). Returns (leaves before, input, labels,
    loss, grads, batch statistics after); the leaves before are the float32
    init, the same as `_jax_student`'s."""
    import jax
    import jax.numpy as jnp
    from flax import nnx

    from kd_cheap_conv_tpu import config
    from kd_cheap_conv_tpu.kd.replace import CheapConvSpec, replace_cheap_convs
    from kd_cheap_conv_tpu.models import build_model

    rng = np.random.RandomState(seed)
    x = rng.randn(n, 33, 33, 3).astype(np.float32)
    labels = rng.randint(0, 6, (n, 33, 33))
    old = {s: getattr(config, s) for s in switches}
    with jax.enable_x64(True):
        jm = nnx.jit(lambda: build_model("deeplabv3plus_mobilenet", 6, 16,
                                         rngs=nnx.Rngs(0)))()
        replace_cheap_convs(jm, CheapConvSpec(kind="separable"),
                            scope="classifier", rngs=nnx.Rngs(1))
        jm.classifier.aspp.dropout.rate = 0.0
        before = _jax_flat(nnx.state(jm, nnx.Any(nnx.Param, nnx.BatchStat)))
        graphdef, state = nnx.split(jm)
        jm = nnx.merge(graphdef, jax.tree.map(
            lambda v: v.astype(jnp.float64)
            if jnp.issubdtype(v.dtype, jnp.floating) else v, state))

        def loss(model, x):
            return jnp.mean((model(x) - jax.nn.one_hot(labels, 6,
                                                       dtype=jnp.float64))
                            ** 2)

        try:
            for s in switches:
                setattr(config, s, True)
            val, grads = nnx.jit(nnx.value_and_grad(loss))(
                jm, jnp.asarray(x, jnp.float64))
        finally:
            for s, v in old.items():
                setattr(config, s, v)
        after = _jax_flat(nnx.state(jm, nnx.BatchStat))
    return before, x, labels, float(val), _jax_flat(grads), after


def _count_plain(monkeypatch):
    """Calls of each plain version, by name without `_ref`: the separable
    conv, the decoder passes, the decoder upsample and its gradient, the
    depthwise conv, its dx and its dk."""
    counts = {}
    for mod, names in ((tdec, ("sep_fwd_ref", "head_fwd_ref", "head_bwd_ref",
                               "sep_bwd_ref")), (tsep, ("separable_ref",)),
                       (tup, ("resize_bilinear_up_ref",
                              "resize_bilinear_up_bwd_ref")),
                       (tdw, ("depthwise_conv2d_ref", "depthwise_dx_ref",
                              "depthwise_dk_ref"))):
        for name in names:
            orig = getattr(mod, name)

            def spy(*args, _orig=orig, _name=name, **kw):
                counts[_name[:-4]] = counts.get(_name[:-4], 0) + 1
                return _orig(*args, **kw)

            monkeypatch.setattr(mod, name, spy)
    return counts


def _port_student_grads(before, x, labels, dtype):
    """(model after one train-mode forward + backward in `dtype`, loss)."""
    from kd_cheap_conv_tpu_torch.convert import state_dict_from_jax
    from kd_cheap_conv_tpu_torch.kd.replace import replace_cheap_convs
    from kd_cheap_conv_tpu_torch.models import build_model

    tm = build_model("deeplabv3plus_mobilenet", 6, 16)
    replace_cheap_convs(tm, scope="classifier")
    tm.classifier.aspp.dropout.p = 0.0
    tm.load_state_dict(state_dict_from_jax(before), strict=True)
    tm = tm.to(dtype=dtype, memory_format=torch.channels_last).train()
    assert tm.classifier._fused_head_active(False)
    logits = tm(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2))
    onehot = F.one_hot(torch.from_numpy(labels), 6).permute(0, 3, 1, 2)
    loss = ((logits - onehot) ** 2).mean()
    loss.backward()
    return tm, float(loss.detach())


def test_student_train_matches_jax_fused_decoder(monkeypatch):
    """Batch 4 (at batch 2 the ASPP pooling branch's train BN sees two
    samples per channel: tests/test_torch_train.py). The train BNs of this
    random network leave the gradients ill-conditioned. The head's
    parameter gradients are held to 3x the port's own f32 error against its
    f64 run (plus 1e-4 of their norm, per tensor plus 1e-3 of the largest
    entry), as that file's KD-step test holds the update. The backbone's
    gradient is held against an f64 run of the JAX student (stock, every
    leaf in f64, `_jax_student64`): the port's f64 gradient to relative L2
    1e-6 (measured 7.7e-8 at this seed; both models take the ASPP pooling
    mean in f32), and the port's f32 gradient within 3x the port's own f32
    error against its f64 run (measured 1.15e-3 relative L2), as the head
    is held. The JAX f32 run is held beside them at relative L2 5e-2: its
    train BNs take the variance as E[x^2] - E[x]^2 in f32, which over seeds
    0-5 and 11 sets it 6.3e-3 to 1.8e-2 from the port's f64 run."""
    from kd_cheap_conv_tpu_torch.convert import state_dict_from_jax

    before, x, labels, want_val, want_g, want_after = _jax_student(11, 4)
    before64, x64, _, _, want_g64, _ = _jax_student64(11, 4)
    assert all(np.array_equal(before[k], before64[k]) for k in before)
    assert np.array_equal(x, x64)
    t64, _ = _port_student_grads(before, x, labels, torch.float64)
    counts = _count_plain(monkeypatch)
    tm, loss = _port_student_grads(before, x, labels, torch.float32)
    # the three ASPP branches forward; the four decoder passes once each;
    # the decoder upsample forward and backward; the stride-1 depthwise
    # convs of features[8..17] (10) and the ASPP branches' recomputed
    # depthwise (3), forward, dx and dk each
    assert counts == {"separable": 3, "sep_fwd": 1, "head_fwd": 1,
                      "head_bwd": 1, "sep_bwd": 1, "resize_bilinear_up": 1,
                      "resize_bilinear_up_bwd": 1, "depthwise_conv2d": 13,
                      "depthwise_dx": 13, "depthwise_dk": 13}, counts
    np.testing.assert_allclose(loss, want_val, rtol=1e-4)
    want = {k: v.double().numpy() for k, v in
            state_dict_from_jax(want_g).items()}
    want64 = {k: v.numpy() for k, v in state_dict_from_jax(want_g64).items()}
    got = {k: p.grad.double().numpy() for k, p in tm.named_parameters()}
    g64 = {k: p.grad.numpy() for k, p in t64.named_parameters()}
    assert set(got) == set(want) == set(want64)

    def norm(d):
        return np.sqrt(sum(np.sum(v ** 2) for v in d.values()))

    head = [k for k in got if k.startswith("classifier.")]
    err = norm({k: got[k] - want[k] for k in head})
    noise = norm({k: got[k] - g64[k] for k in head})
    assert err <= 3 * noise + 1e-4 * norm({k: want[k] for k in head}), \
        (err, noise)
    top = max(np.abs(want[k]).max() for k in head)
    for k in head:
        assert np.abs(got[k] - want[k]).max() <= (
            3 * np.abs(got[k] - g64[k]).max() + 1e-3 * top), k
    body = [k for k in got if k not in head]
    scale = norm({k: want64[k] for k in body})
    rel64 = norm({k: g64[k] - want64[k] for k in body}) / scale
    assert rel64 <= 1e-6, rel64
    err = norm({k: got[k] - want64[k] for k in body})
    noise = norm({k: got[k] - g64[k] for k in body})
    assert err <= 3 * noise + 1e-6 * scale, (err, noise)
    rel = (norm({k: got[k] - want[k] for k in body})
           / norm({k: want[k] for k in body}))
    assert rel <= 5e-2, rel
    after = state_dict_from_jax(want_after)
    sd = tm.state_dict()
    heads = [k for k in after if k.startswith(("classifier.fuse.bn",
                                               "classifier.aspp."))
             and not k.endswith("num_batches_tracked")]
    assert len(heads) == 14, heads            # fuse + 6 ASPP BNs, mean + var
    for k in heads:
        np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert int(sd["classifier.fuse.bn.num_batches_tracked"]) == 1


@pytest.mark.parametrize("case", ["hint_taps", "eval", "dense_fuse"])
def test_guard_leaves_fused_head_untaken(case, monkeypatch):
    from kd_cheap_conv_tpu_torch.kd.replace import replace_cheap_convs
    from kd_cheap_conv_tpu_torch.models import build_model

    m = build_model("deeplabv3plus_mobilenet", 6, 16,
                    generator=torch.Generator().manual_seed(0))
    if case != "dense_fuse":
        replace_cheap_convs(m, scope="classifier")
    m.classifier.aspp.dropout.p = 0.0
    m.train()
    head = m.classifier
    assert head._fused_head_active(False) == (case != "dense_fuse")
    if case == "eval":
        m.eval()
    ref = copy.deepcopy(m)
    counts = _count_plain(monkeypatch)
    x = torch.randn(2, 3, 33, 33, generator=torch.Generator().manual_seed(1))
    feats = m.backbone(x)
    ref_feats = ref.backbone(x)
    hint = case == "hint_taps"
    assert not head._fused_head_active(hint)
    got = head(feats, return_features=hint)
    want = ref.classifier._forward_modules(ref_feats, hint)
    if hint:
        (got, gt), (want, wt) = got, want
        np.testing.assert_allclose(gt["head"].detach().numpy(),
                                   wt["head"].detach().numpy(), **VAL)
    assert not any(k in counts for k in ("sep_fwd", "head_fwd"))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **VAL)


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


def _close(got, want, tol):
    g, w = got.float().cpu(), want.float().cpu()
    err = float((g - w).abs().max())
    assert err <= tol * max(float(w.abs().max()), 1e-6), err


def _card_head(dtype, dev, n=2, h=13, w=17, cl=16, cu=32, cm=64, nc=5,
               seed=6):
    d = _pass_data(seed, n, h, w, cl, cu, cm, nc)
    act = {k: d[k].to(dev, dtype) for k in ("low", "up")}
    a, s = tdec.sep_fwd_ref(act["low"], act["up"], d["k"].float().to(dev),
                            d["pw"].to(dev, dtype))
    m, v = tst._moments(s, tst._count(a))
    g32 = torch.Generator().manual_seed(seed + 1)
    return {**act, "a": a, "k": d["k"].float().to(dev),
            "pw": d["pw"].to(dev, dtype), "wc": d["wc"].to(dev, dtype),
            "bc": d["bc"].float().to(dev),
            "bn": tst._bn_pack(m, v, d["g"].float().to(dev),
                               d["b"].float().to(dev)),
            "gl": d["gl"].to(dev, dtype),
            "gu": torch.randn(a.shape, generator=g32).to(dev, dtype),
            "pn": torch.stack([m, v, d["g"].float().to(dev),
                               torch.randn(cm, generator=g32).to(dev) * 30,
                               torch.randn(cm, generator=g32).to(dev) * 30,
                               torch.full((cm,), 1.0 / tst._count(a),
                                          device=dev)], 1)}


def _head_calls(d):
    return {"sep_fwd": ((d["low"], d["up"], d["k"], d["pw"]),
                        lambda *a: (lambda y, s: (y, *tst._moments(
                            s, tst._count(y))))(*tdec.sep_fwd_ref(*a))),
            "head_fwd": ((d["a"], d["bn"], d["wc"], d["bc"]),
                         lambda *a: (tdec.head_fwd_ref(*a),)),
            "head_bwd": ((d["gl"], d["a"], d["bn"], d["wc"]),
                         tdec.head_bwd_ref),
            "sep_bwd": ((d["gu"], d["a"], d["low"], d["up"], d["pn"],
                         d["k"], d["pw"]), tdec.sep_bwd_ref)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["sep_fwd", "head_fwd", "head_bwd",
                                  "sep_bwd"])
def test_head_kernel_matches_plain_on_card(cuda, name, dtype):
    d = _card_head(dtype, cuda)
    args, plain = _head_calls(d)[name]
    fn = getattr(tdec, f"run_{name}")
    before = fn.launches
    got = fn(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = plain(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    for g, w in zip(got, want):
        _close(g, w, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,dil,k,co", [
    ((2, 9, 11, 16), 1, 3, 24), ((2, 33, 33, 320), 6, 3, 256),
    ((2, 49, 49, 2048), 12, 3, 256),
    ((1, 20, 23, 64), 3, 5, 264), ((3, 7, 5, 8), 2, 3, 8),
    # config #2's ASPP branches, config #3's 2048-wide ones and the serving
    # decoder's fuse conv, at their full shapes
    ((16, 33, 33, 320), 6, 3, 256), ((16, 33, 33, 320), 12, 3, 256),
    ((16, 33, 33, 320), 18, 3, 256), ((4, 49, 49, 2048), 6, 3, 256),
    ((4, 49, 49, 2048), 12, 3, 256), ((4, 49, 49, 2048), 18, 3, 256),
    ((4, 129, 129, 304), 1, 3, 256),
    # k 7 at a dilation whose row of taps outgrows one TMA box: a box a
    # tap, the weight streamed through two slots beside the x ring
    ((1, 130, 130, 512), 40, 7, 256)])
def test_separable_kernel_matches_plain_on_card(cuda, dtype, shape, dil, k,
                                                co):
    """The separable conv against its plain version (f32 1e-4 of the
    largest output, bf16 one ulp of it), and a second call bit for bit:
    the kernel's sums, over CTAs that may share an item, do not depend on
    timing."""
    g = torch.Generator(cuda).manual_seed(2)
    c = shape[-1]
    x = torch.randn(shape, device=cuda, generator=g).to(dtype)
    dw = (torch.randn((c, 1, k, k), device=cuda, generator=g) / k).to(dtype)
    pw = (torch.randn((co, c, 1, 1), device=cuda, generator=g)
          * c ** -0.5).to(dtype)
    before = tsep.run_separable.launches
    got = tsep.run_separable(x, dw, pw, dil)
    again = tsep.run_separable(x, dw, pw, dil)
    want = tsep.separable_ref(x, dw, pw, dil)
    torch.cuda.synchronize()
    assert tsep.run_separable.launches == before + 2
    assert torch.equal(got, again)
    if dtype == torch.float32:
        _close(got, want, 1e-4)
    else:       # t enters the product as bf16 hi + lo: one ulp of the output
        err = float((got.float() - want.float()).abs().max())
        assert err <= _bf16_ulp(float(want.float().abs().max())), err


# name: (n, h, w, cl, cu, cm): P1 at config #2's and config #3's full
# shapes, and the small head's
SEP_FWD_GEO = {
    "config2": (16, 129, 129, 48, 256, 256),
    "config3": (4, 193, 193, 48, 256, 256),
    "small": (2, 13, 17, 16, 32, 64),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SEP_FWD_GEO))
def test_sep_fwd_matches_plain_on_card(cuda, name):
    """P1 in bf16 against its plain version: a within 1.6e-2 of its largest
    value, the batch mean and variance (f32 on both sides) within 1e-4
    (chip_smoke.py's HEAD_SUM_TOL); a, mean and variance of a second call
    bit for bit (the moments are summed in the kernel over integer
    tickets)."""
    n, h, w, cl, cu, cm = SEP_FWD_GEO[name]
    g = torch.Generator(device=cuda).manual_seed(
        sorted(SEP_FWD_GEO).index(name))
    ci = cl + cu
    low = torch.randn((n, h, w, cl), device=cuda, generator=g).to(
        torch.bfloat16)
    up = torch.randn((n, h, w, cu), device=cuda, generator=g).to(
        torch.bfloat16)
    k = torch.randn((ci, 9), device=cuda, generator=g) / 3
    pw = (torch.randn((cm, ci), device=cuda, generator=g)
          * ci ** -0.5).to(torch.bfloat16)
    before = tdec.run_sep_fwd.launches
    got = tdec.run_sep_fwd(low, up, k, pw)
    again = tdec.run_sep_fwd(low, up, k, pw)
    a, sums = tdec.sep_fwd_ref(low, up, k, pw)
    want = (a, *tst._moments(sums, tst._count(a)))
    torch.cuda.synchronize()
    assert tdec.run_sep_fwd.launches == before + 2
    for what, x, y, ref, tol in zip(("a", "mean", "var"), got, again, want,
                                    (1.6e-2, 1e-4, 1e-4)):
        assert x.shape == ref.shape and x.dtype == ref.dtype, what
        assert torch.equal(x, y), what
        _close(x, ref, tol)


@pytest.mark.gpu
def test_head_backward_kernels_are_deterministic(cuda):
    d = _card_head(torch.bfloat16, cuda, n=4, h=33, w=35)
    calls = _head_calls(d)
    for name in ("head_bwd", "sep_bwd"):
        fn = getattr(tdec, f"run_{name}")
        a, b = fn(*calls[name][0]), fn(*calls[name][0])
        for x, y in zip(a, b):
            assert torch.equal(x, y), name


@pytest.mark.gpu
def test_head_kernels_refuse_what_they_do_not_take(cuda):
    d = _card_head(torch.float32, cuda)
    with pytest.raises(ValueError, match="divisible by 16"):
        tdec.run_head_fwd(d["a"][..., :40].contiguous(), d["bn"][:40],
                          d["wc"][:, :40].contiguous(), d["bc"])
    x = torch.zeros(1, 5, 5, 12, device=cuda)
    with pytest.raises(ValueError, match="divisible by 8"):
        tsep.run_separable(x, torch.zeros(12, 1, 3, 3, device=cuda),
                           torch.zeros(8, 12, 1, 1, device=cuda), 1)
    with pytest.raises(TypeError):
        tsep.run_separable(x.double(), torch.zeros(12, 1, 3, 3, device=cuda),
                           torch.zeros(8, 12, 1, 1, device=cuda), 1)
    # the plan's limits: P1's moments take at most 256 output channels (one
    # block), k at most 7, dtypes float32 and bfloat16 only
    from kd_cheap_conv_tpu_torch import native

    lib = native.library()
    x16 = torch.zeros(1, 5, 5, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="with moments"):
        tsep.launch_sep_fwd(x16, None, torch.zeros(9, 16, device=cuda),
                            torch.zeros(264, 16, device=cuda,
                                        dtype=torch.bfloat16), 3, 1, True)
    with pytest.raises(ValueError, match="odd k up to 7"):
        tsep.run_separable(x16, torch.zeros(16, 1, 9, 9, device=cuda),
                           torch.zeros(8, 16, 1, 1, device=cuda), 1)
    assert lib.kdcc_sep_fwd_plan(0, 1, 1, 5, 5, 16, 0, 264, 3, 1, 1) == -1
    assert lib.kdcc_sep_fwd_plan(0, 1, 1, 5, 5, 16, 0, 264, 3, 1, 0) >= 1
    assert lib.kdcc_sep_fwd_plan(0, 2, 1, 5, 5, 16, 0, 8, 3, 1, 0) == -1
    assert lib.kdcc_sep_fwd_plan(0, 1, 1, 5, 5, 16, 0, 8, 9, 1, 0) == -1


# ---------------------------------------------------------------------------
# B2 in bf16 (one launch, csrc/head_convs.cu sbw): its plan by hand on the
# CPU; on the card, config #2's and config #3's geometry and the edges
# against the plain version in both dtypes, twice bit for bit, and the
# plan's mirror
# ---------------------------------------------------------------------------

# (n, h, w, ci, cm) -> (CTAs, chunks, groups, scratch floats, tickets,
# stages): ceil(ci / 64) chunks; tiles of 6 x 14 outputs; min(tiles, 132 //
# chunks) CTAs a chunk in groups of 8; (CTAs + chunks x groups) partials of
# (cm + 9) x 64 floats; chunks x (groups + 1) tickets; the ring stages of
# 32 x cm x 4 bytes that fit in 232448 - 1024 - 131072 - 32 - 16 = 100304,
# at most 4
@pytest.mark.parametrize("geo,want", [
    # config #2: 16 x 22 x 10 = 3520 tiles, 132 // 5 = 26 CTAs a chunk
    ((16, 129, 129, 304, 256), (130, 5, 4, 150 * 265 * 64, 25, 3)),
    # config #3: 4 x 33 x 14 = 1848 tiles
    ((4, 193, 193, 304, 256), (130, 5, 4, 150 * 265 * 64, 25, 3)),
    # 2 x 3 x 2 = 12 tiles, one chunk: groups (8, 4)
    ((2, 13, 17, 48, 64), (12, 1, 2, 14 * 73 * 64, 3, 4)),
    # 2 x 4 x 3 = 24 tiles, 3 chunks (64, 64, 8)
    ((2, 20, 30, 136, 128), (72, 3, 3, 81 * 137 * 64, 12, 4)),
    ((1, 1, 1, 8, 16), (1, 1, 1, 2 * 25 * 64, 2, 4)),
])
def test_sep_bwd_plan_by_hand(geo, want):
    assert tdec.sep_bwd_plan(*geo) == want


# B1 in bf16 (one launch, csrc/head_convs.cu hbw): (P, cm, nc) -> (CTAs,
# groups, scratch floats, tickets, stages, shared memory bytes).
# min(ceil(P / 64), 132) CTAs in groups of 12; a partial of nc cm + 2 cm +
# ceil(nc / 4) 4 floats per CTA and per group; groups + 1 tickets; a ring
# slot of ceil(cm / 64) boxes of 8192 bytes and g's 64 nc 2 bytes rounded
# up to 1024, at most 4 slots beside 1024 + 8192 ceil(cm / 64) + 2 x 64 x
# 40 x 2 + 32 (cm + 8) 2 + 16 cm + 48 fixed bytes, within 232448
@pytest.mark.parametrize("geo,want", [
    # config #2: 16 x 129² = 266256 pixels, 4161 tiles; a partial 5376 +
    # 512 + 24 floats; slot 32768 + 3072, fixed 65072
    ((266256, 256, 21), (132, 11, 143 * 5912, 12, 4, 65072 + 4 * 35840)),
    # config #3: 4 x 193² = 148996 pixels; 4864 + 512 + 20 floats
    ((148996, 256, 19), (132, 11, 143 * 5396, 12, 4, 65072 + 4 * 35840)),
    # ragged: 3 x 11 x 7 = 231 pixels (4 tiles, the last of 39), Cm 48
    # (one box, partly outside the tensor); 912 + 96 + 20 floats
    ((231, 48, 19), (4, 1, 5 * 1028, 2, 4, 23856 + 4 * 11264)),
    # one pixel, the smallest Cm, one class: 16 + 32 + 4 floats
    ((1, 16, 1), (1, 1, 2 * 52, 2, 4, 21296 + 4 * 9216)),
    # 32 classes, 37 tiles in groups (12, 12, 12, 1)
    ((2310, 256, 32), (37, 4, 41 * 8736, 5, 4, 65072 + 4 * 36864)),
], ids=["config2", "config3", "ragged", "one_pixel", "nc32"])
def test_head_bwd_plan_by_hand(geo, want):
    assert tdec.head_bwd_plan(*geo) == want


# name: (n, h, w, cm, nc); config #2's and config #3's B1 and the edges: a
# ragged last tile with Cm 48 (its one box partly outside the tensor), the
# smallest widths, 32 classes
HEAD_BWD_GEO = {
    "config2": (16, 129, 129, 256, 21),
    "config3": (4, 193, 193, 256, 19),
    "ragged_cm48": (3, 11, 7, 48, 19),
    "cm16_nc1": (1, 5, 7, 16, 1),
    "nc32": (2, 33, 35, 256, 32),
}


def _head_bwd_args(name, dtype, dev):
    n, h, w, cm, nc = HEAD_BWD_GEO[name]
    g = torch.Generator(device=dev).manual_seed(
        sorted(HEAD_BWD_GEO).index(name))

    def randn(*s, scale=1.0):
        return scale * torch.randn(s, device=dev, generator=g)

    bn = tst._bn_pack(randn(cm, scale=0.1),
                      0.5 + torch.rand(cm, device=dev, generator=g),
                      1 + randn(cm, scale=0.2), randn(cm, scale=0.1))
    return (randn(n, h, w, nc).to(dtype), randn(n, h, w, cm).to(dtype), bn,
            randn(nc, cm, scale=cm ** -0.5).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(HEAD_BWD_GEO))
def test_head_bwd_matches_plain_on_card(cuda, name, dtype):
    """B1 at config #2's and config #3's shapes and the edges against its
    plain version, as chip_smoke.py's head_parity holds it: gu, dWc and dbc
    within 1e-4 (f32) or 1.6e-2 (bf16) of the largest plain value, the BN
    sums (f32 on both sides) within 1e-4; the sums, dWc and dbc of a second
    call bit for bit."""
    args = _head_bwd_args(name, dtype, cuda)
    before = tdec.run_head_bwd.launches
    got, again = tdec.run_head_bwd(*args), tdec.run_head_bwd(*args)
    assert tdec.run_head_bwd.launches == before + 2
    want = tdec.head_bwd_ref(*args)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    for what, a, b, w in zip(("gu", "sums", "dwc", "dbc"), got, again, want):
        assert a.shape == w.shape and a.dtype == w.dtype, what
        if what != "gu":
            assert torch.equal(a, b), what
        _close(a, w, 1e-4 if what == "sums" else tol)


@pytest.mark.gpu
def test_head_bwd_plan_mirrors_the_kernel(cuda):
    from kd_cheap_conv_tpu_torch import native

    lib = native.library()
    for n, h, w, cm, nc in HEAD_BWD_GEO.values():
        want = list(tdec.head_bwd_plan(n * h * w, cm, nc))
        assert [lib.kdcc_head_bwd_plan(k, n * h * w, cm, nc)
                for k in range(6)] == want, (n, h, w, cm, nc)


# name: (n, h, w, cl, cu, cm); config #2's and config #3's B2 and the edges:
# a last chunk of 8 channels, the smallest Cm, one pixel
SEP_BWD_GEO = {
    "config2": (16, 129, 129, 48, 256, 256),
    "config3": (4, 193, 193, 48, 256, 256),
    "chunks_40_96_128": (2, 20, 30, 40, 96, 128),
    "cm16": (1, 5, 7, 8, 8, 16),
    "one_pixel": (1, 1, 1, 16, 32, 64),
}


def _sep_bwd_args(name, dtype, dev):
    n, h, w, cl, cu, cm = SEP_BWD_GEO[name]
    g = torch.Generator(device=dev).manual_seed(
        sorted(SEP_BWD_GEO).index(name))
    ci, m = cl + cu, n * h * w

    def randn(*s, scale=1.0):
        return scale * torch.randn(s, device=dev, generator=g)

    pn = torch.stack([randn(cm, scale=0.1),
                      0.5 + torch.rand(cm, device=dev, generator=g),
                      1 + randn(cm, scale=0.2), randn(cm, scale=m ** 0.5),
                      randn(cm, scale=m ** 0.5),
                      torch.full((cm,), 1.0 / m, device=dev)], 1)
    return (randn(n, h, w, cm).to(dtype), randn(n, h, w, cm).to(dtype),
            randn(n, h, w, cl).to(dtype), randn(n, h, w, cu).to(dtype), pn,
            randn(ci, 9, scale=1 / 3), randn(cm, ci, scale=ci ** -0.5).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(SEP_BWD_GEO))
def test_sep_bwd_matches_plain_on_card(cuda, name, dtype):
    args = _sep_bwd_args(name, dtype, cuda)
    before = tdec.run_sep_bwd.launches
    got, again = tdec.run_sep_bwd(*args), tdec.run_sep_bwd(*args)
    assert tdec.run_sep_bwd.launches == before + 2
    want = tdec.sep_bwd_ref(*args)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    for what, a, b, w in zip(("g_low", "g_up", "dpw", "dk"), got, again,
                             want):
        assert a.shape == w.shape and a.dtype == w.dtype, what
        if what in ("dpw", "dk"):
            assert torch.equal(a, b), what
        _close(a, w, tol)


@pytest.mark.gpu
def test_sep_bwd_plan_mirrors_the_kernel(cuda):
    from kd_cheap_conv_tpu_torch import native

    lib = native.library()
    for n, h, w, cl, cu, cm in SEP_BWD_GEO.values():
        want = list(tdec.sep_bwd_plan(n, h, w, cl + cu, cm))
        assert [lib.kdcc_sep_bwd_plan(k, n, h, w, cl, cu, cm)
                for k in range(6)] == want, (n, h, w, cl, cu, cm)
