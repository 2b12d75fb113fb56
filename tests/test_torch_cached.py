"""The port's cached-teacher mode (config #1) against the JAX package's.

- (a) The full-resolution fused CE + KL (kd_cheap_conv_tpu_torch.ops.
  losses_fused `fused_ce_kl_loss`, its plain versions on CPU tensors) and
  its autograd gradient against the JAX Pallas `fused_ce_kl_loss(...,
  interpret=True)` and its vjp, on (2, 5, 33, 35) logits with ~5% void
  labels, labels outside [0, C) and a teacher beyond the 3e4 clip, the
  cotangent on total, on task alone and on kd alone: values rtol 1e-4, ds
  rtol 1e-3 / atol 1e-5 (tests/test_torch_loss.py's limits). The cache's
  float16 NHWC teacher gives what its float32 class-major copy gives.
- (b) The cache file: one written by JAX `precompute_teacher_logits` (the
  KD test's (1, 1, 1, 1) ResNet DeepLabV3+ teacher, 4 synthetic images at
  33²) loads in the port's `CachedLogitsDataset` with the same images and
  labels; the port's own cache of the same teacher holds JAX's logits to
  one float16 ulp; a length mismatch raises.
- (c) One cached KD step (`make_kd_train_step(cached_teacher=True)`, SGD +
  PolyLR) from the same student weights and cached logits as JAX's
  `make_kd_train_step(cached_teacher=True)`, held as tests/test_torch_train.py
  holds the live step (losses rtol 1e-4; parameters and running statistics
  rtol 1e-3 / atol 1e-5; the update within 3x the port's own f32 noise),
  but the update against the JAX step run in f64 (see the test). On the
  8-device CPU mesh without a mesh argument
  the JAX step takes its plain loss (JAX `fused_loss_applicable`); the
  port's takes its fused loss's plain version, which (a) holds to the JAX
  kernel. The step's argument checks.
- (d) `main --kd --cached_logits` end to end on the CPU: the cache is
  built by the teacher's fused paths (stem, 6 bottlenecks, decoder
  upsample per batch), then training takes the full-resolution loss once
  per step, with finite losses.

The `gpu` cases hold the two loss kernels against their plain versions on
the card and skip where there is none.
"""

import contextlib
import copy
import io
import math

import numpy as np
import pytest
import torch

from kd_cheap_conv_tpu_torch.ops import losses_fused as lf

torch.set_num_threads(1)

VAL_TOL = dict(rtol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
# (T, alpha, beta)
CASES = {"t4": (4.0, 0.5, 0.5), "t2": (2.0, 0.7, 0.3)}


def _data(n=2, c=5, h=33, w=35, seed=0):
    rng = np.random.RandomState(seed)
    s = (2 * rng.randn(n, c, h, w)).astype(np.float32)
    t = (3 * rng.randn(n, c, h, w)).astype(np.float32)
    t[0, 1, 2, :] = 1e5                   # beyond the 3e4 clip
    t[1, :, 4, 4] = -4e4
    t[1, :3, 7, :9] = 5e4                 # ties at the clip
    lbl = rng.randint(0, c, (n, h, w)).astype(np.int64)
    lbl[rng.rand(n, h, w) < 0.05] = 255
    lbl[1, h // 2, :w // 2] = c + 2       # outside [0, C): one-hot zero, valid
    return s, t, lbl


def _jax_loss(s, t, lbl, T, alpha, beta, ct):
    import jax
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas.losses import fused_ce_kl_loss

    tj, lj = jnp.asarray(t), jnp.asarray(lbl.astype(np.int32))
    outs, vjp = jax.vjp(lambda sj: fused_ce_kl_loss(
        sj, tj, lj, T, alpha, beta, 255, 3e4, True), jnp.asarray(s))
    (ds,) = vjp(tuple(jnp.float32(c) for c in ct))
    return [float(o) for o in outs], np.asarray(ds)


def _port_loss(s, t, lbl, T, alpha, beta, ct):
    st = torch.from_numpy(s).requires_grad_()
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(t)
    outs = lf.fused_ce_kl_loss(st, t, torch.from_numpy(lbl), T, alpha, beta)
    (ds,) = torch.autograd.grad(outs, st, [torch.tensor(c) for c in ct])
    return [float(o.detach()) for o in outs], ds.numpy()


# ---------------------------------------------------------------------------
# (a) the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ct", [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                                (0.0, 0.0, 1.0)],
                         ids=["total", "task", "kd"])
@pytest.mark.parametrize("case", list(CASES))
def test_full_resolution_loss_matches_jax_kernel(case, ct):
    s, t, lbl = _data()
    want, want_ds = _jax_loss(s, t, lbl, *CASES[case], ct)
    got, got_ds = _port_loss(s, t, lbl, *CASES[case], ct)
    np.testing.assert_allclose(got, want, **VAL_TOL)
    np.testing.assert_allclose(got_ds, want_ds, **GRAD_TOL)


def test_float16_nhwc_teacher_reads_as_its_float32_copy():
    s, t, lbl = _data(seed=1)
    t16 = np.clip(t.transpose(0, 2, 3, 1), -6e4, 6e4).astype(np.float16)
    view = torch.from_numpy(t16).permute(0, 3, 1, 2)
    wide = np.ascontiguousarray(t16.astype(np.float32).transpose(0, 3, 1, 2))
    got, got_ds = _port_loss(s, view, lbl, 4.0, 0.5, 0.5, (1.0, 0.0, 0.0))
    want, want_ds = _port_loss(s, wide, lbl, 4.0, 0.5, 0.5, (1.0, 0.0, 0.0))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got_ds, want_ds, rtol=1e-6, atol=1e-12)


def test_kd_total_loss_takes_the_fused_loss_for_class_major_logits(
        monkeypatch):
    from kd_cheap_conv_tpu_torch.kd.distill import KDConfig, kd_total_loss

    s, t, lbl = (torch.from_numpy(a) for a in _data(seed=2))
    calls = []
    orig = lf.ce_kl_fwd_ref
    monkeypatch.setattr(lf, "ce_kl_fwd_ref",
                        lambda *a: calls.append(1) or orig(*a))
    fused, aux = kd_total_loss(s, t, lbl, KDConfig())
    plain, _ = kd_total_loss(s, t, torch.where(lbl < 5, lbl, 255),
                             KDConfig(loss_type="focal_loss"))
    assert calls == [1]
    want, _ = _port_loss(*(a.numpy() for a in (s, t, lbl)), 4.0, 0.5, 0.5,
                         (1.0, 0.0, 0.0))
    np.testing.assert_allclose([float(fused), float(aux["task"]),
                                float(aux["kd"])], want, rtol=1e-6)
    assert math.isfinite(float(plain))


# ---------------------------------------------------------------------------
# (b) the cache file
# ---------------------------------------------------------------------------

def _synthetic(length=4, seed=9):
    from kd_cheap_conv_tpu.data import SyntheticSegmentation as JaxSynth
    from kd_cheap_conv_tpu_torch.data import SyntheticSegmentation

    return (JaxSynth(6, size=33, length=length, seed=seed),
            SyntheticSegmentation(6, size=33, length=length, seed=seed))


def test_cache_files_read_across_packages(tmp_path):
    from kd_cheap_conv_tpu.kd.cached import \
        precompute_teacher_logits as jax_precompute
    from kd_cheap_conv_tpu_torch.kd.cached import (CachedLogitsDataset,
                                                   precompute_teacher_logits)
    from test_torch_train import _kd_pair

    (_, jt, _), (_, tt, _) = _kd_pair()
    jds, tds = _synthetic()
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_precompute(jt, jds, jpath, batch_size=3, seed=5)
    precompute_teacher_logits(copy.deepcopy(tt), tds, tpath, batch_size=3,
                              seed=5)
    cached = CachedLogitsDataset(tds, jpath)
    assert (cached.seed, cached.epoch, len(cached)) == (5, 0, 4)
    want = np.load(jpath)["logits"]
    got = np.load(tpath)["logits"]
    assert got.dtype == want.dtype == np.float16
    assert got.shape == want.shape == (4, 33, 33, 6)
    ulp = np.spacing(np.abs(want)).astype(np.float32)
    assert (np.abs(got.astype(np.float32) - want.astype(np.float32))
            <= ulp + 1e-5 * np.abs(want).max()).all()
    for i in range(4):
        img, lbl, logits = cached[i]
        jimg, jlbl = jds.__getitem__(i, np.random.default_rng((5, 0, i)))
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(lbl, jlbl)
        np.testing.assert_array_equal(logits, want[i])
    with pytest.raises(ValueError, match="entries"):
        CachedLogitsDataset(_synthetic(length=5)[1], jpath)


# ---------------------------------------------------------------------------
# (c) the cached KD step
# ---------------------------------------------------------------------------

def _port_cached_step(ts, kw, x, lbl, t, lr, dtype):
    from kd_cheap_conv_tpu_torch.kd.distill import KDConfig
    from kd_cheap_conv_tpu_torch.train.optim import make_optimizer
    from kd_cheap_conv_tpu_torch.train.steps import make_kd_train_step

    ts = copy.deepcopy(ts).to(dtype)
    before = {k: v.clone() for k, v in ts.state_dict().items()}
    opt, sched = make_optimizer(ts.named_parameters(), lr=lr, max_iters=10)
    step_fn = make_kd_train_step(ts, None, opt, KDConfig(**kw), sched,
                                 cached_teacher=True)
    metrics = step_fn(torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype),
                      torch.from_numpy(lbl), torch.from_numpy(t))
    return metrics, {k: (v.double().numpy(),
                         ts.state_dict()[k].double().numpy())
                     for k, v in before.items()}, \
        {k for k, _ in ts.named_parameters()}


def _jax_cached_step(js, kw, x, lbl, t, lr, dtype):
    """One JAX cached-teacher step on a clone of `js` with every float
    leaf, the image and the logits in `dtype` (float64 under
    jax.enable_x64); returns (metrics, the port's state_dict after it as
    float64 numpy arrays)."""
    import jax
    import jax.numpy as jnp
    from flax import nnx

    from kd_cheap_conv_tpu.kd.distill import KDConfig as JaxKD
    from kd_cheap_conv_tpu.train import make_kd_train_step as jax_step
    from kd_cheap_conv_tpu.train import make_optimizer as jax_opt
    from kd_cheap_conv_tpu_torch.convert import state_dict_from_jax
    from test_torch_model import jax_leaves

    with jax.enable_x64(dtype == jnp.float64):
        graphdef, state = nnx.split(nnx.clone(js))
        js = nnx.merge(graphdef, jax.tree.map(
            lambda v: v.astype(dtype)
            if jnp.issubdtype(v.dtype, jnp.floating) else v, state))
        _, params, _ = nnx.split(js, nnx.Param, ...)
        tx = jax_opt({"student": params}, lr=lr, max_iters=10,
                     label_fn=lambda d: ("backbone"
                                         if d.startswith("student.backbone")
                                         else "head"))
        init, step, t_state = jax_step(js, None, tx, JaxKD(**kw),
                                       cached_teacher=True)
        assert t_state == ()
        state, metrics = step(init(), (
            jnp.asarray(x, dtype), jnp.asarray(lbl, jnp.int32),
            jnp.asarray(t.astype(np.float32), dtype)), t_state)
        nnx.update(js, state.params["student"], state.rest)
        leaves = {k: np.asarray(v, np.float64)
                  for k, v in jax_leaves(js).items()}
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.double().numpy()
             for k, v in state_dict_from_jax(leaves).items()})


def test_cached_kd_step_matches_jax():
    """The JAX f32 step's own rounding noise on this ill-conditioned train-BN
    backbone (its update sits ~1% from its f64 update, relative L2) exceeds
    the port's (~0.5%), so the update is held to the JAX f64 step: the
    port's f64 update to relative L2 1e-6, its f32 update within 3x its own
    f32-vs-f64 error (overall, and per tensor plus 1e-3 of the step's
    largest entry). Losses and the parameters and statistics after the step
    are held to the JAX f32 step (rtol 1e-4; rtol 1e-3, atol 1e-5)."""
    import jax.numpy as jnp

    from test_torch_train import _batch, _kd_pair

    (js, _, _), (ts, _, _) = _kd_pair()
    kw = dict(temperature=2.0, alpha=0.6, beta=0.4)
    lr = 1e-6
    x, lbl = _batch()
    t = (4 * np.random.RandomState(11).randn(*x.shape[:3], 6)).astype(
        np.float16)
    t[0, :3, :5, 2] = 6e4                 # the clip binds
    jm, want = _jax_cached_step(js, kw, x, lbl, t, lr, jnp.float32)
    _, want64 = _jax_cached_step(js, kw, x, lbl, t, lr, jnp.float64)
    _, upd64, _ = _port_cached_step(ts, kw, x, lbl, t, lr, torch.float64)
    got, upd, names = _port_cached_step(ts, kw, x, lbl, t, lr, torch.float32)
    for k in ("loss", "task", "kd"):
        np.testing.assert_allclose(float(got[k]), jm[k], rtol=1e-4,
                                   err_msg=k)
    assert set(upd) == set(want)
    for k, w in want.items():
        before, after = upd[k]
        if k.endswith("num_batches_tracked"):
            assert after == before + 1, k
            continue
        np.testing.assert_allclose(after, w, rtol=1e-3, atol=1e-5, err_msg=k)
    d_got = {k: upd[k][1] - upd[k][0] for k in names}
    d_64 = {k: upd64[k][1] - upd64[k][0] for k in names}
    d_want = {k: want64[k] - upd[k][0] for k in names}

    def norm(d):
        return np.sqrt(sum(np.sum(v ** 2) for v in d.values()))

    assert norm({k: d_64[k] - d_want[k] for k in names}) <= 1e-6 * norm(
        d_want)
    err = norm({k: d_got[k] - d_want[k] for k in names})
    noise = norm({k: d_got[k] - d_64[k] for k in names})
    assert err <= 3 * noise + 1e-4 * norm(d_want), (err, noise)
    step_max = max(np.abs(d).max() for d in d_want.values())
    for k in names:
        assert np.abs(d_got[k] - d_want[k]).max() <= (
            3 * np.abs(d_got[k] - d_64[k]).max() + 1e-3 * step_max), k
    assert sum(np.abs(d).max() > 0 for d in d_want.values()) > 100


def test_cached_step_arguments():
    from kd_cheap_conv_tpu_torch.kd.distill import KDConfig
    from kd_cheap_conv_tpu_torch.train.steps import make_kd_train_step

    m = torch.nn.Linear(1, 1)
    with pytest.raises(ValueError, match="hint taps"):
        make_kd_train_step(m, None, None, KDConfig(hint_taps=("out",)),
                           cached_teacher=True)
    with pytest.raises(ValueError, match="teacher required"):
        make_kd_train_step(m, None, None, KDConfig())
    step = make_kd_train_step(m, None, None, KDConfig(), cached_teacher=True)
    with pytest.raises(ValueError, match="teacher logits"):
        step(torch.zeros(1), torch.zeros(1))


# ---------------------------------------------------------------------------
# (d) main end to end
# ---------------------------------------------------------------------------

def test_main_cached_logits_end_to_end(tmp_path, monkeypatch):
    from kd_cheap_conv_tpu_torch import main as port_main
    from kd_cheap_conv_tpu_torch.ops import rchain as trc
    from kd_cheap_conv_tpu_torch.ops import tstem as tts
    from kd_cheap_conv_tpu_torch.ops import upsample as tup

    calls = {}
    for mod, name in ((trc, "bneck_eval_ref"), (tts, "fused_stem_pool_eval_ref"),
                      (tup, "resize_bilinear_up_ref"), (lf, "ce_kl_fwd_ref"),
                      (lf, "ce_kl_bwd_ref"), (lf, "ce_kl_upsampled_fwd_ref")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=orig, **k: (
            calls.__setitem__(_n, calls.get(_n, 0) + 1) or _f(*a, **k)))
    cache = tmp_path / "t.npz"
    argv = ["--kd", "--cached_logits", str(cache), "--device", "cpu",
            "--dataset", "synthetic", "--crop_size", "33", "--batch_size",
            "2", "--total_itrs", "2", "--val_interval", "2",
            "--print_interval", "1", "--num_classes", "6",
            "--teacher_model", "deeplabv3plus_resnet50", "--replace_scope",
            "classifier", "--num_workers", "2", "--cache_batch_size", "64",
            "--cached_det_transform", "--ckpt_dir", str(tmp_path / "ck")]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert port_main.main(argv) == 0
    text = out.getvalue()
    losses = [float(ln.split("loss=")[1].split(",")[0])
              for ln in text.splitlines() if ln.startswith("Itrs")]
    assert len(losses) == 2 and all(map(math.isfinite, losses)), text
    assert np.load(cache)["logits"].shape == (256, 33, 33, 6)
    # the cache build: 4 teacher batches of 64, each through the stem,
    # layer1's 3 and layer2's last 3 bottlenecks and the decoder upsample;
    # training: one full-resolution forward and backward per step, and the
    # student's decoder upsample in the steps and the final validation
    assert {k: calls.get(k, 0) for k in (
        "fused_stem_pool_eval_ref", "bneck_eval_ref", "ce_kl_fwd_ref",
        "ce_kl_bwd_ref", "ce_kl_upsampled_fwd_ref")} == {
        "fused_stem_pool_eval_ref": 4, "bneck_eval_ref": 24,
        "ce_kl_fwd_ref": 2, "ce_kl_bwd_ref": 2,
        "ce_kl_upsampled_fwd_ref": 0}, calls
    # a second run reads the cache instead of building it
    calls.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_main.main(argv) == 0
    assert "bneck_eval_ref" not in calls and calls["ce_kl_fwd_ref"] == 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("s_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t_form", ["f32_nchw", "f16_nhwc"])
@pytest.mark.parametrize("shape", [(2, 21, 65, 65), (3, 5, 17, 23)])
def test_full_resolution_kernels_match_plain_on_card(cuda, shape, s_dtype,
                                                     t_form):
    g = torch.Generator(cuda).manual_seed(3)
    n, c, h, w = shape
    s = (2 * torch.randn(shape, device=cuda, generator=g)).to(s_dtype)
    t = 1e5 * (2 * torch.rand((n, h, w, c), device=cuda, generator=g) - 1)
    t = (t.half().permute(0, 3, 1, 2) if t_form == "f16_nhwc"
         else t.permute(0, 3, 1, 2).contiguous())
    lbl = torch.randint(0, c, (n, h, w), device=cuda, generator=g)
    lbl = lbl.masked_fill(torch.rand((n, h, w), device=cuda, generator=g)
                          < 0.05, 255)
    scales = torch.tensor([0.5 / lbl.numel(), 2.0 / lbl.numel()],
                          device=cuda)
    args = (4.0, 255, 3e4)
    before = (lf.ce_kl_fwd.launches, lf.ce_kl_bwd.launches)
    sums = lf.ce_kl_fwd(s, t, lbl, *args)
    ds, again = (lf.ce_kl_bwd(s, t, lbl, scales, *args) for _ in range(2))
    want = lf.ce_kl_fwd_ref(s, t, lbl, *args)
    want_ds = lf.ce_kl_bwd_ref(s, t, lbl, scales, *args)
    torch.cuda.synchronize()
    assert (lf.ce_kl_fwd.launches, lf.ce_kl_bwd.launches) == (
        before[0] + 1, before[1] + 2)
    assert float(((sums - want).abs() / want.abs().clamp_min(1.0)).max()) \
        <= 1e-4
    err = (ds.float() - want_ds.float()).abs()
    assert bool((err <= 1e-7 + 1e-4 * want_ds.float().abs()).all())
    assert torch.equal(ds, again)
