"""The port's decoder upsample (kd_cheap_conv_tpu_torch.ops.upsample) and
depthwise conv (ops.dwconv) against the JAX package's Pallas kernels, which
run in interpret mode on the CPU. Inputs come from numpy seeds; bf16 inputs
are the f32 values rounded to bf16 on both sides.

- (a) `resize_bilinear_up_ref` and `resize_bilinear_up_bwd_ref` against the
  JAX `resize_bilinear_up(..., interpret=True)` and its `jax.vjp`, at
  2x33²x16 -> 129² (the decoder's 4x), 1x9x5 -> 17x23 and 1x4x4 -> 7x7:
  f32 values and gradients to 1e-5 of their largest entry (max abs error);
  bf16 within one bf16 ulp of the output's largest magnitude, which holds
  the rounding points (z rounded to bf16 between the two passes, u not).
- (b) `depthwise_conv2d_ref`, `depthwise_dx_ref` and `depthwise_dk_ref`
  against the JAX `depthwise_conv2d_pallas(..., interpret=True)` and its
  vjp at (2, 19, 17, 8) k3 d1, (1, 33, 33, 16) k3 d2, (1, 21, 19, 8) k5 d1
  and (1, 9, 9, 16) k3 d6 (the dilation past half the image, as the ASPP's
  at 33²): f32 at tests/test_pallas_dwconv.py's limits (values 1e-5,
  dx rtol 1e-4 / atol 1e-5, dk 1e-4 / 1e-4), bf16 within one ulp.
- (c) The guards and the plain calls that prove they were taken: the
  port's decoder routes its ASPP upsample, and `Conv2d` its stride-1
  depthwise convs, through the new functions; stride 2, an even kernel, a
  grouped conv with groups < C, a downsample and an identity resize stay
  stock.
- (d) The port's train-mode `deeplabv3plus_mobilenet` (head
  separable-converted, 33², batch 4) against the JAX one with
  `use_pallas_upsample`, `use_pallas_dw` and `use_pallas_decoder` set, run
  in f64: the loss, the parameter gradients and the BN running statistics,
  the port's f64 run as the noise yardstick (tests/test_torch_head.py's
  method), the plain calls counted.

- (e) The weight-gradient kernel's work list (ops/dwconv.py `dw_dk_plan`,
  `dw_dk_items`, mirrors of csrc/resample_dw.cu `dkw::plan`): at every
  geometry of configs #2 and #3 and the card cases' shapes, each (pixel,
  channel) once, every tap's x row staged beside its g rows, a stage's
  bytes within DK_STAGE, a block's CTAs contiguous and within its slots;
  the split the same for every dilation; the class order puts every
  vertical tap on the next or previous sequence row.

The `gpu` cases hold each CUDA kernel against its plain version on the card
(the weight gradient also twice bit for bit from C = 24 at k = 7 to 2048
at dilation 12, and as one kernel launch with no torch op after it) and
skip where there is none.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kd_cheap_conv_tpu_torch.models.layers import Conv2d
from kd_cheap_conv_tpu_torch.ops import dwconv as tdw
from kd_cheap_conv_tpu_torch.ops import upsample as tup
from test_torch_head import (_count_plain, _jax_student64,
                             _port_student_grads)

torch.set_num_threads(1)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bf16_ulp(v):
    """One bf16 ulp at magnitude v (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _close(got, want, dtype, rtol):
    """f32: max |got - want| <= rtol * max |want|; bf16: one ulp of
    max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    lim = rtol * top if dtype == "float32" else _bf16_ulp(top)
    assert err <= lim, (err, lim)


def _jnp(a, dtype):
    import jax.numpy as jnp

    return jnp.asarray(a).astype(dtype)


def _np(a):
    import jax.numpy as jnp

    return np.asarray(a.astype(jnp.float32))


# ---------------------------------------------------------------------------
# (a) the upsample
# ---------------------------------------------------------------------------

UP_CASES = [((2, 33, 33, 16), (129, 129)), ((1, 9, 5, 16), (17, 23)),
            ((1, 4, 4, 16), (7, 7))]


def _up_data(shape, size, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(shape[0], *size, shape[3]).astype(np.float32))


@functools.cache
def _jax_up(shape, size, dtype):
    import jax

    from kd_cheap_conv_tpu.ops.pallas.upsample import resize_bilinear_up

    x, gy = _up_data(shape, size)
    y, vjp = jax.vjp(lambda a: resize_bilinear_up(a, size, interpret=True),
                     _jnp(x, dtype))
    return _np(y), _np(vjp(_jnp(gy, dtype))[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,size", UP_CASES)
def test_upsample_matches_jax_kernel(shape, size, dtype):
    want_y, want_gx = _jax_up(shape, size, dtype)
    x, gy = (torch.from_numpy(a).to(DTYPES[dtype]) for a in _up_data(shape,
                                                                      size))
    assert tup.supports_upsample(x.shape, size, x.dtype)
    y = tup.resize_bilinear_up_ref(x, size)
    gx = tup.resize_bilinear_up_bwd_ref(gy, shape[1:3])
    assert y.shape == want_y.shape and gx.shape == x.shape
    assert y.dtype == gx.dtype == x.dtype
    _close(y.float().numpy(), want_y, dtype, 1e-5)
    _close(gx.float().numpy(), want_gx, dtype, 1e-5)
    # the autograd Function takes the same plain versions on the CPU
    xr = x.clone().requires_grad_()
    out = tup.resize_bilinear_up(xr, size)
    out.backward(gy)
    assert torch.equal(out.detach(), y) and torch.equal(xr.grad, gx)


def test_upsample_tables_fold_clipped_taps():
    """Where both taps of an output index clip onto one input index, the
    table holds their summed weight and a zero (upsample.py:46-60), and the
    backward lists are the forward taps transposed."""
    fidx, fw, bidx, bw = tup._axis_tables(4, 7)
    m = tup._halfpix_np(4, 7)
    assert fidx[0, 0] == 0 and fw[0, 0] == 1.0 and fw[0, 1] == 0.0
    dense = np.zeros_like(m)
    for o in range(7):
        for j in range(2):
            dense[o, fidx[o, j]] += fw[o, j]
    np.testing.assert_array_equal(dense, m)
    back = np.zeros_like(m)
    for i in range(4):
        for o, w in zip(bidx[i], bw[i]):
            if o >= 0:
                back[o, i] += w
    np.testing.assert_array_equal(back, m)


# ---------------------------------------------------------------------------
# (b) the depthwise conv
# ---------------------------------------------------------------------------

DW_CASES = [((2, 19, 17, 8), 3, 1), ((1, 33, 33, 16), 3, 2),
            ((1, 21, 19, 8), 5, 1), ((1, 9, 9, 16), 3, 6)]


def _dw_data(shape, k, seed=1):
    """x, the taps (C, k*k) in the JAX `kr` order, the cotangent g."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    kr = (rng.randn(shape[3], k * k) / k).astype(np.float32)
    return x, kr, rng.randn(*shape).astype(np.float32)


@functools.cache
def _jax_dw(shape, k, d, dtype):
    import jax

    from kd_cheap_conv_tpu.ops.pallas.dwconv import depthwise_conv2d_pallas

    x, kr, g = _dw_data(shape, k)
    y, vjp = jax.vjp(lambda a, b: depthwise_conv2d_pallas(a, b, k, d, True),
                     _jnp(x, dtype), _jnp(kr, dtype))
    dx, dk = vjp(_jnp(g, dtype))
    return _np(y), _np(dx), _np(dk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,d", DW_CASES)
def test_depthwise_matches_jax_kernel(shape, k, d, dtype):
    want_y, want_dx, want_dk = _jax_dw(shape, k, d, dtype)
    tdt = DTYPES[dtype]
    x, kr, g = _dw_data(shape, k)
    x, g = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    taps = torch.from_numpy(kr).to(tdt).float().t().contiguous()
    y = tdw.depthwise_conv2d_ref(x, taps, k, d)
    dx = tdw.depthwise_dx_ref(g, taps, k, d)
    dk = tdw.depthwise_dk_ref(x, g, k, d).to(tdt)    # the JAX rule's rounding
    assert y.dtype == dx.dtype == tdt and dk.shape == (k * k, shape[3])
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-4,
                                   atol=1e-5, err_msg="dx")
        np.testing.assert_allclose(dk.t().numpy(), want_dk, rtol=1e-4,
                                   atol=1e-4, err_msg="dk")
    else:
        _close(y.float().numpy(), want_y, dtype, None)
        _close(dx.float().numpy(), want_dx, dtype, None)
        _close(dk.t().float().numpy(), want_dk, dtype, None)


@pytest.mark.parametrize("d", [1, 3])
def test_depthwise_function_matches_torch_autograd(d):
    """`depthwise_conv2d` (what `Conv2d` calls) against F.conv2d's value
    and autograd gradients, f64, with a bias added as `Conv2d` adds it."""
    gen = torch.Generator().manual_seed(d)
    c, k = 16, 3
    x = torch.randn(2, c, 11, 9, generator=gen, dtype=torch.float64)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    w = torch.randn(c, 1, k, k, generator=gen,
                    dtype=torch.float64).requires_grad_()
    g = torch.randn(2, c, 11, 9, generator=gen, dtype=torch.float64)
    y = tdw.depthwise_conv2d(x, w, d)
    assert y.is_contiguous(memory_format=torch.channels_last)
    x2, w2 = (t.detach().clone().requires_grad_() for t in (x, w))
    y2 = F.conv2d(x2, w2, None, 1, d, d, c)
    np.testing.assert_allclose(y.detach().numpy(), y2.detach().numpy(),
                               rtol=1e-12, atol=1e-12)
    (y * g).sum().backward()
    (y2 * g).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), x2.grad.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(w.grad.numpy(), w2.grad.numpy(), rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# (c) the guards, and the plain calls that show the new path was taken
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,taken", [
    (dict(kernel_size=3, padding=1), True),
    (dict(kernel_size=3, padding=2, dilation=2), True),
    (dict(kernel_size=5, padding=2), True),
    (dict(kernel_size=3, padding=1, stride=2), False),
    (dict(kernel_size=4, padding=1), False),
    (dict(kernel_size=3, padding=1, groups=4), False),
    (dict(kernel_size=3, padding=0), False)])
def test_conv2d_takes_the_depthwise_path_where_its_guard_holds(
        kw, taken, monkeypatch):
    counts = _count_plain(monkeypatch)
    kw = {"groups": 16, **kw}
    conv = Conv2d(16, 16, generator=torch.Generator().manual_seed(0), **kw)
    assert conv.depthwise_active(torch.float32) is taken
    assert not conv.depthwise_active(torch.float64)
    x = torch.randn(2, 16, 9, 9, generator=torch.Generator().manual_seed(1))
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    y = conv(x)
    want = F.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding,
                    conv.dilation, conv.groups)
    np.testing.assert_allclose(y.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    y.sum().backward()
    n = int(taken)
    assert counts.get("depthwise_conv2d", 0) == n
    assert counts.get("depthwise_dx", 0) == counts.get("depthwise_dk", 0) == n


@pytest.mark.parametrize("shape,size,dtype,ok", [
    ((16, 33, 33, 256), (129, 129), torch.bfloat16, True),
    ((4, 33, 33, 256), (129, 129), torch.float32, True),
    ((2, 9, 5, 16), (9, 23), torch.float32, True),
    ((16, 33, 33, 256), (33, 33), torch.float32, False),     # identity
    ((16, 129, 129, 256), (33, 33), torch.float32, False),   # downsample
    ((2, 9, 9, 16), (17, 7), torch.float32, False),          # down in W
    ((16, 33, 33, 21), (129, 129), torch.float32, False),    # C % 8
    ((16, 33, 33, 256), (129, 129), torch.float64, False),
    ((33, 33, 256), (129, 129), torch.float32, False)])
def test_supports_upsample(shape, size, dtype, ok):
    assert tup.supports_upsample(shape, size, dtype) is ok


def _port_head(seed=0):
    from kd_cheap_conv_tpu_torch.kd.replace import replace_cheap_convs
    from kd_cheap_conv_tpu_torch.models.deeplab import DeepLabHeadV3Plus

    gen = torch.Generator().manual_seed(seed)
    head = DeepLabHeadV3Plus(32, 16, 5, dtype=None, generator=gen)
    replace_cheap_convs(head, generator=gen)
    head.aspp.dropout.p = 0.0
    return head.to(memory_format=torch.channels_last).train()


@pytest.mark.parametrize("size,taken", [((9, 9), True), ((3, 3), False)])
def test_decoder_upsample_takes_the_kernel_path(size, taken, monkeypatch):
    """The ASPP output (3x3 here) is upsampled to the low-level features'
    size through ops.upsample, forward and backward; an identity resize
    (low-level features at the ASPP's size) stays stock. Both give the
    stock module path's logits."""
    head = _port_head()
    gen = torch.Generator().manual_seed(2)
    feats = {"low_level": torch.randn(2, 16, *size, generator=gen),
             "out": torch.randn(2, 32, 3, 3, generator=gen)}
    feats = {k: v.contiguous(memory_format=torch.channels_last)
             for k, v in feats.items()}
    stock = _port_head()
    stock.upsample_active = lambda x, size: False
    want = stock(feats)
    counts = _count_plain(monkeypatch)
    got = head(feats)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    got.sum().backward()
    n = int(taken)
    assert counts.get("resize_bilinear_up", 0) == n
    assert counts.get("resize_bilinear_up_bwd", 0) == n


# ---------------------------------------------------------------------------
# (d) the train-mode student against the JAX one with both switches set
# ---------------------------------------------------------------------------

SWITCHES = ("use_pallas_upsample", "use_pallas_dw", "use_pallas_decoder")


def test_student_train_matches_jax_pallas_upsample_and_dw(monkeypatch):
    """Against an f64 run of the JAX student with the three switches on
    (`_jax_student64`: every leaf and the input in f64, its Pallas kernels
    computing in f32 inside), so that the JAX f32 run's E[x^2] - E[x]^2
    BN variance does not set the limit: the port's f64 gradients to
    relative L2 1e-4 (measured 1.3e-5 head, 2.5e-5 backbone: the JAX
    kernels' f32 arithmetic through the ill-conditioned train BNs); the
    port's f32 gradients, head and backbone, within 3x the port's own f32
    error against its f64 run (plus 1e-4 of their norm, per tensor plus
    1e-3 of the largest entry), as tests/test_torch_head.py holds the
    head; the loss at rtol 1e-4 and every BN running statistic at rtol
    1e-4, atol 1e-5."""
    from kd_cheap_conv_tpu_torch.convert import state_dict_from_jax

    before, x, labels, want_val, want_g, want_after = _jax_student64(
        11, 4, SWITCHES)
    t64, _ = _port_student_grads(before, x, labels, torch.float64)
    counts = _count_plain(monkeypatch)
    tm, loss = _port_student_grads(before, x, labels, torch.float32)
    # the decoder upsample forward and backward; the 10 stride-1 depthwise
    # convs of features[8..17] and the three ASPP branches' recomputed
    # depthwise (forward, dx and dk each); the separable and decoder passes
    assert counts == {"separable": 3, "sep_fwd": 1, "head_fwd": 1,
                      "head_bwd": 1, "sep_bwd": 1, "resize_bilinear_up": 1,
                      "resize_bilinear_up_bwd": 1, "depthwise_conv2d": 13,
                      "depthwise_dx": 13, "depthwise_dk": 13}, counts
    np.testing.assert_allclose(loss, want_val, rtol=1e-4)
    want = {k: v.numpy() for k, v in state_dict_from_jax(want_g).items()}
    got = {k: p.grad.double().numpy() for k, p in tm.named_parameters()}
    g64 = {k: p.grad.numpy() for k, p in t64.named_parameters()}
    assert set(got) == set(want)

    def norm(d):
        return np.sqrt(sum(np.sum(v ** 2) for v in d.values()))

    head = [k for k in got if k.startswith("classifier.")]
    for part in (head, [k for k in got if k not in head]):
        scale = norm({k: want[k] for k in part})
        rel64 = norm({k: g64[k] - want[k] for k in part}) / scale
        assert rel64 <= 1e-4, rel64
        err = norm({k: got[k] - want[k] for k in part})
        noise = norm({k: got[k] - g64[k] for k in part})
        assert err <= 3 * noise + 1e-4 * scale, (err, noise)
        top = max(np.abs(want[k]).max() for k in part)
        for k in part:
            assert np.abs(got[k] - want[k]).max() <= (
                3 * np.abs(got[k] - g64[k]).max() + 1e-3 * top), k
    after = state_dict_from_jax(want_after)
    sd = tm.state_dict()
    stats = [k for k in after if not k.endswith("num_batches_tracked")]
    assert len(stats) == 2 * 59, len(stats)
    for k in stats:
        np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# (e) the weight-gradient kernel's work list (ops/dwconv.py `dw_dk_plan`,
# mirrored by csrc/resample_dw.cu dkw::plan)
# ---------------------------------------------------------------------------

# every shape the kernel meets in a step: config #2's features[8..17] (bf16)
# and ASPP recomputes (f32), config #3's ASPP recomputes (f32); then the
# on-card cases' small and narrow shapes
DK_SHAPES = ([((16, 33, 33, c), 3, d, 2) for c, d in ((384, 1), (576, 1),
                                                      (960, 2))]
             + [((16, 33, 33, 320), 3, d, 4) for d in (6, 12, 18)]
             + [((4, 49, 49, 2048), 3, d, 4) for d in (6, 12, 18)]
             + [((3, 7, 5, 24), 7, 1, 2), ((2, 33, 33, 960), 3, 18, 2),
                ((1, 21, 19, 8), 5, 3, 4), ((2, 19, 17, 8), 3, 1, 4),
                ((2, 257, 257, 32), 3, 1, 4), ((1, 40, 600, 24), 7, 2, 2)])


@pytest.mark.parametrize("shape,k,d,esize", DK_SHAPES)
def test_dw_dk_work_list_covers_each_pixel_and_channel_once(shape, k, d,
                                                            esize):
    n, h, w, c = shape
    p = tdw.dw_dk_plan(n, h, w, c, k, esize)
    assert p.cb * p.ncb == c and p.u * p.pl == tdw.DK_THREADS
    items = tdw.dw_dk_items(n, h, w, c, k, d, esize)
    assert len(items) == p.items and {it[0] for it in items} == set(
        range(p.grid))
    seen = np.zeros((n, h, c), np.int64)
    nbox = -(-w // 256)
    bw = w if nbox == 1 else (-(-w // nbox) + 7) // 8 * 8
    assert nbox == 1 or bw * p.cb * esize % 128 == 0 and nbox * bw >= w
    row = -(-nbox * bw * p.cb * esize // 128) * 128
    for _, blk, img, grows, xrows in items:
        seen[img, grows, blk * p.cb:(blk + 1) * p.cb] += 1
        # every x row a tap of these g rows reads is staged with them
        need = {y + (t - k // 2) * d for y in grows for t in range(k)}
        assert {y for y in need if 0 <= y < h} <= set(xrows)
        assert (len(xrows) + len(grows)) * row <= tdw.DK_STAGE
    assert (seen == 1).all()
    # a block's contributing CTAs fit its scratch slots
    for blk in range(p.ncb):
        ctas = {it[0] for it in items if it[1] == blk}
        assert len(ctas) <= p.mc and ctas == set(range(min(ctas),
                                                       max(ctas) + 1))
    assert p.scratch == p.ncb * p.mc * k * k * p.cb


@pytest.mark.parametrize("shape,k,esize", [((16, 33, 33, 384), 3, 2),
                                           ((4, 49, 49, 2048), 3, 4),
                                           ((3, 7, 5, 24), 7, 2)])
def test_dw_dk_split_depends_on_the_shape_alone(shape, k, esize):
    """The plan takes no dilation, and the items differ across dilations
    only in which image rows a band holds (the class order)."""
    n, h, w, c = shape
    lists = [tdw.dw_dk_items(n, h, w, c, k, d, esize) for d in (1, 2, 6, 18)]
    for items in lists[1:]:
        assert [it[:3] for it in items] == [it[:3] for it in lists[0]]
        assert [len(it[3]) for it in items] == [len(it[3]) for it in lists[0]]
    assert tdw.dw_dk_items(n, h, w, c, k, 6, esize) == lists[2]


@pytest.mark.parametrize("h,d", [(33, 1), (33, 2), (33, 6), (33, 18),
                                 (49, 12), (7, 9)])
def test_dw_dk_class_order_keeps_taps_within_one_row(h, d):
    """In the class order a vertical tap of any dilation is the next or
    previous sequence row, or leaves the image."""
    seq = tdw.dw_dk_seq_rows(h, d)
    assert sorted(seq) == list(range(h))
    at = {y: i for i, y in enumerate(seq)}
    for y in range(h):
        for dy in (-d, d):
            if 0 <= y + dy < h:
                assert at[y + dy] == at[y] + (1 if dy > 0 else -1)


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


def _card_close(got, want, dtype):
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    _close(g, w, "float32" if dtype == torch.float32 else "bfloat16", 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,size", [((2, 33, 33, 256), (129, 129)),
                                        ((2, 49, 49, 256), (193, 193)),
                                        ((1, 9, 5, 16), (17, 23)),
                                        ((3, 4, 4, 8), (7, 7))])
def test_upsample_kernels_match_plain_on_card(cuda, shape, size, dtype):
    g = torch.Generator(cuda).manual_seed(4)
    x = torch.randn(shape, device=cuda, generator=g).to(dtype)
    gy = torch.randn((shape[0], *size, shape[3]), device=cuda,
                     generator=g).to(dtype)
    before = (tup.run_up_fwd.launches, tup.run_up_bwd.launches)
    y, gx = tup.run_up_fwd(x, size), tup.run_up_bwd(gy, shape[1:3])
    want_y = tup.resize_bilinear_up_ref(x, size)
    want_gx = tup.resize_bilinear_up_bwd_ref(gy, shape[1:3])
    torch.cuda.synchronize()
    assert (tup.run_up_fwd.launches, tup.run_up_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _card_close(y, want_y, dtype)
    _card_close(gx, want_gx, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,d", DW_CASES + [((2, 33, 33, 320), 3, 18),
                                                  ((2, 49, 49, 2048), 3, 6),
                                                  ((3, 7, 5, 24), 7, 1)])
def test_depthwise_kernels_match_plain_on_card(cuda, shape, k, d, dtype):
    gen = torch.Generator(cuda).manual_seed(5)
    x, g = (torch.randn(shape, device=cuda, generator=gen).to(dtype)
            for _ in range(2))
    taps = (torch.randn((k * k, shape[3]), device=cuda, generator=gen)
            / k).to(dtype).float()
    y = tdw.run_dw_conv(x, taps, k, d)
    dx = tdw.run_dw_dx(g, taps, k, d)
    dk, dk2 = tdw.run_dw_dk(x, g, k, d), tdw.run_dw_dk(x, g, k, d)
    torch.cuda.synchronize()
    _card_close(y, tdw.depthwise_conv2d_ref(x, taps, k, d), dtype)
    _card_close(dx, tdw.depthwise_dx_ref(g, taps, k, d), dtype)
    _card_close(dk.to(dtype), tdw.depthwise_dk_ref(x, g, k, d).to(dtype),
                dtype)
    assert torch.equal(dk, dk2)


@pytest.mark.gpu
def test_resample_dw_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(1, 5, 5, 12, device=cuda)
    with pytest.raises(ValueError, match="divisible by 8"):
        tup.run_up_fwd(x, (9, 9))
    with pytest.raises(ValueError, match="divisible by 8"):
        tdw.run_dw_conv(x, torch.zeros(9, 12, device=cuda), 3, 1)
    with pytest.raises(TypeError):
        tdw.run_dw_conv(torch.zeros(1, 5, 5, 8, device=cuda,
                                    dtype=torch.float64),
                        torch.zeros(9, 8, device=cuda), 3, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,d", [((3, 7, 5, 24), 7, 1),
                                       ((3, 7, 5, 24), 7, 2),
                                       ((2, 33, 33, 320), 3, 18),
                                       ((2, 33, 33, 960), 3, 2),
                                       ((1, 49, 49, 2048), 3, 12),
                                       ((2, 20, 257, 32), 3, 1)])
def test_dw_dk_kernel_is_deterministic_on_card(cuda, shape, k, d, dtype):
    gen = torch.Generator(cuda).manual_seed(7)
    x, g = (torch.randn(shape, device=cuda, generator=gen).to(dtype)
            for _ in range(2))
    dk, dk2 = tdw.run_dw_dk(x, g, k, d), tdw.run_dw_dk(x, g, k, d)
    torch.cuda.synchronize()
    assert torch.equal(dk, dk2)
    _card_close(dk.to(dtype), tdw.depthwise_dk_ref(x, g, k, d).to(dtype),
                dtype)


@pytest.mark.gpu
def test_run_dw_dk_is_one_launch_without_a_torch_reduction(cuda):
    from torch.profiler import ProfilerActivity, profile

    x, g = (torch.randn((16, 33, 33, 384), device=cuda).to(torch.bfloat16)
            for _ in range(2))
    tdw.run_dw_dk(x, g, 3, 1)            # scratch and tickets exist from here
    torch.cuda.synchronize()
    before = tdw.run_dw_dk.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dk = tdw.run_dw_dk(x, g, 3, 1)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    assert tdw.run_dw_dk.launches == before + 1
    assert len(kernels) == 1 and "dw_dk_kernel" in kernels[0].name
    assert dk.shape == (9, 384) and dk.dtype == torch.float32
