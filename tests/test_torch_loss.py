"""The port's losses against the JAX package's.

- The fused CE + KL over upsampled logits (kd_cheap_conv_tpu_torch.ops.
  losses_fused, its plain version on CPU tensors) against the JAX Pallas
  kernel `fused_ce_kl_loss_upsampled` run in interpret mode, on (2, 5, 9, 9)
  logits upsampled to 33² and to a height that is not a multiple of the
  kernel's tiles (35 x 33), with void labels, labels outside [0, C), and
  teacher logits beyond the clip: values at rtol 1e-4, ds at rtol 1e-3,
  atol 1e-5 (the JAX tests' own tolerances), also with the cotangent on task
  and on kd alone (the folded grad scales).
- The plain losses (ops.losses) against the JAX package's ops/losses.py.
- BatchNorm's running variance after a train-mode forward (the biased batch
  variance, as flax's BatchNorm keeps it), rtol 1e-6.

The `gpu` cases hold kernels C and D against their plain versions on the
card and skip where there is none. JAX is imported inside the JAX-side
helpers only, so that those cases also run where JAX is not installed
(`python -m pytest --noconftest -m gpu tests/test_torch_loss.py`).
"""

import numpy as np
import pytest
import torch

from kd_cheap_conv_tpu_torch.ops import losses, losses_fused as lf

torch.set_num_threads(1)

VAL_TOL = dict(rtol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
# (h, w, H, W, T, alpha, beta)
CASES = {
    "33sq": (9, 9, 33, 33, 4.0, 0.5, 0.5),
    "35x33": (9, 9, 35, 33, 2.0, 0.7, 0.3),
}


def _data(h, w, H, W, n=2, c=5, seed=0):
    rng = np.random.RandomState(seed)
    s = rng.randn(n, c, h, w).astype(np.float32)
    t = (3 * rng.randn(n, c, h, w)).astype(np.float32)
    t[0, 1, 2, :] = 1e5          # beyond the 3e4 clip
    t[1, :, 4, 4] = -4e4
    lbl = rng.randint(0, c, (n, H, W)).astype(np.int64)
    lbl[0, :4, :6] = 255
    lbl[1, H // 2, :W // 2] = c + 2   # outside [0, C): one-hot zero, valid
    return s, t, lbl


def _jax_fused(s, t, lbl, H, W, T, alpha, beta, ct=(1.0, 0.0, 0.0)):
    """(total, task, kd) and d(ct . outputs)/ds from the JAX kernel."""
    import jax
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas.losses import \
        fused_ce_kl_loss_upsampled

    tj, lj = jnp.asarray(t), jnp.asarray(lbl.astype(np.int32))

    def f(sj):
        return fused_ce_kl_loss_upsampled(sj, tj, lj, H, W, T, alpha, beta,
                                          255, 3e4, True)

    outs, vjp = jax.vjp(f, jnp.asarray(s))
    (ds,) = vjp(tuple(jnp.float32(c) for c in ct))
    return [float(o) for o in outs], np.asarray(ds)


def _port_fused(s, t, lbl, H, W, T, alpha, beta, ct=(1.0, 0.0, 0.0)):
    st = torch.from_numpy(s).requires_grad_()
    outs = lf.fused_ce_kl_loss_upsampled(st, torch.from_numpy(t),
                                         torch.from_numpy(lbl), H, W, T,
                                         alpha, beta)
    (ds,) = torch.autograd.grad(outs, st, [torch.tensor(c) for c in ct])
    return [float(o.detach()) for o in outs], ds.numpy()


@pytest.mark.parametrize("ct", [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                                (0.0, 0.0, 1.0)],
                         ids=["total", "task", "kd"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_loss_matches_jax_kernel(case, ct):
    h, w, H, W, T, alpha, beta = CASES[case]
    s, t, lbl = _data(h, w, H, W)
    want, want_ds = _jax_fused(s, t, lbl, H, W, T, alpha, beta, ct)
    got, got_ds = _port_fused(s, t, lbl, H, W, T, alpha, beta, ct)
    np.testing.assert_allclose(got, want, **VAL_TOL)
    np.testing.assert_allclose(got_ds, want_ds, **GRAD_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_ce_only_matches_jax_kernel(case):
    import jax
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops.pallas.losses import fused_ce_loss_upsampled

    h, w, H, W, *_ = CASES[case]
    s, _, lbl = _data(h, w, H, W)
    lj = jnp.asarray(lbl.astype(np.int32))
    want, vjp = jax.vjp(
        lambda sj: fused_ce_loss_upsampled(sj, lj, H, W, 255, True),
        jnp.asarray(s))
    (want_ds,) = vjp(jnp.float32(1.0))
    st = torch.from_numpy(s).requires_grad_()
    got = lf.fused_ce_loss_upsampled(st, torch.from_numpy(lbl), H, W)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **VAL_TOL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_ds),
                               **GRAD_TOL)


def test_teacher_gets_no_gradient_and_beta0_ignores_it():
    s, t, lbl = _data(9, 9, 33, 33)
    st, tt = torch.from_numpy(s).requires_grad_(), \
        torch.from_numpy(t).requires_grad_()
    total, _, _ = lf.fused_ce_kl_loss_upsampled(st, tt, torch.from_numpy(lbl),
                                                33, 33)
    total.backward()
    assert tt.grad is None and st.grad is not None
    a = lf.fused_ce_kl_loss_upsampled(torch.from_numpy(s),
                                      torch.from_numpy(t),
                                      torch.from_numpy(lbl), 33, 33, 4.0,
                                      1.0, 0.0)
    b = lf.fused_ce_kl_loss_upsampled(torch.from_numpy(s),
                                      torch.full_like(torch.from_numpy(t),
                                                      float("nan")),
                                      torch.from_numpy(lbl), 33, 33, 4.0,
                                      1.0, 0.0)
    assert float(a[2]) == 0.0
    np.testing.assert_array_equal([float(x) for x in a],
                                  [float(x) for x in b])


@pytest.mark.parametrize("in_size,out_size", [(129, 513), (9, 35), (9, 33),
                                              (1, 5), (9, 4), (65, 65)])
def test_axis_tables_rebuild_the_bilinear_matrix(in_size, out_size):
    from kd_cheap_conv_tpu.ops.pallas.losses import bilinear_matrix

    lo, frac, ob, oe = lf.axis_tables(in_size, out_size)
    m = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), 1.0 - frac)
    np.add.at(m, (rows, np.minimum(lo + 1, in_size - 1)), frac)
    np.testing.assert_array_equal(m, bilinear_matrix(in_size, out_size))
    for i in range(in_size):       # [ob, oe) is exactly who taps i
        tapped = np.nonzero((lo <= i) & (np.minimum(lo + 1, in_size - 1)
                                         >= i))[0]
        assert list(range(ob[i], oe[i])) == list(tapped)


def test_kernel_plan_fits_shared_memory_at_config2():
    """Config #2 (21 classes, 129² -> 513²) and the largest class count the
    kernels take fit an H100's shared memory in both kernels."""
    for c in (21, lf.MAX_CLASSES):
        p = lf.plan(129, 129, 513, 513)
        assert lf.fwd_smem_bytes(c, p, True) <= lf.SMEM_LIMIT
        assert lf.bwd_smem_bytes(c, p, True) <= lf.SMEM_LIMIT
        assert p["rows"] * p["reg_w"] <= lf.BWD_THREADS
    assert lf.plan(129, 129, 513, 513)["fwd_win"] == (6, 6)


@pytest.mark.parametrize("fn", ["cross_entropy", "focal_loss", "kd_kl_loss",
                                "kd_kl_loss_masked", "hint_l2_loss"])
def test_plain_losses_match_jax(fn):
    import jax.numpy as jnp

    from kd_cheap_conv_tpu.ops import losses as jl

    s, t, lbl = _data(7, 6, 7, 6, c=6, seed=3)
    lbl = np.where(lbl < 6, lbl, 255)          # JAX gathers labels < C only
    args = {"cross_entropy": ((s,), {}), "focal_loss": ((s,), {}),
            "kd_kl_loss": ((s, t / 1e4), dict(temperature=2.0)),
            "kd_kl_loss_masked": ((s, t / 1e4), dict(temperature=2.0,
                                                     labels=lbl)),
            "hint_l2_loss": ((s, t), {})}[fn]
    name = fn.replace("_masked", "")
    pos, kw = args
    if name in ("cross_entropy", "focal_loss"):
        pos = (*pos, lbl)
    if name != "hint_l2_loss":
        kw = dict(kw, channel_axis=1)
    want = getattr(jl, name)(*(jnp.asarray(a) for a in pos),
                             **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                                else v for k, v in kw.items()})
    got = getattr(losses, name)(*(torch.from_numpy(a) for a in pos),
                                **{k: torch.from_numpy(v)
                                   if isinstance(v, np.ndarray) else v
                                   for k, v in kw.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_fused_plain_matches_upsample_then_plain_losses():
    """Where the clip does not bind, the fused loss equals F.interpolate
    followed by ops.losses (the plain kd_total_loss path)."""
    import torch.nn.functional as F

    s, t, lbl = _data(9, 9, 35, 33)
    s, t, lbl = map(torch.from_numpy, (s, t / 1e4, lbl))
    lbl = torch.where(lbl < 5, lbl, 255)
    total, task, kd = lf.fused_ce_kl_loss_upsampled(s, t, lbl, 35, 33, 2.0,
                                                    0.7, 0.3)
    up = dict(size=(35, 33), mode="bilinear", align_corners=False)
    su, tu = F.interpolate(s, **up), F.interpolate(t, **up)
    np.testing.assert_allclose(float(task), float(losses.cross_entropy(su,
                                                                       lbl)),
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(kd), float(losses.kd_kl_loss(su, tu, temperature=2.0)),
        rtol=1e-5)


def test_bn_running_var_is_the_biased_batch_variance():
    """One train-mode forward at batch 2, 5x5, 3 channels: the port's
    running statistics equal flax's (the unbiased variance would be
    n/(n-1) = 50/49 larger in the batch term)."""
    import jax.numpy as jnp
    from flax import nnx

    from kd_cheap_conv_tpu.models.layers import BatchNorm as JaxBN
    from kd_cheap_conv_tpu_torch.models.layers import BatchNorm

    x = np.random.RandomState(0).randn(2, 5, 5, 3).astype(np.float32) * 2 + 1
    jbn = JaxBN(3, rngs=nnx.Rngs(0))
    want_y = np.asarray(jbn(jnp.asarray(x)))
    bn = BatchNorm(3).train()
    got_y = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(jbn.var[...]), rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(jbn.mean[...]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got_y.detach().permute(0, 2, 3, 1).numpy(),
                               want_y, rtol=1e-5, atol=1e-5)
    assert int(bn.num_batches_tracked) == 1


# ---------------------------------------------------------------------------
# on the card: kernels C and D against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on_card(dev, dtype, c, h, w, H, W, n=2, clip_active=False):
    s, t, lbl = _data(h, w, H, W, n=n, c=c, seed=7)
    if not clip_active:
        t = 3 * np.random.RandomState(8).randn(*t.shape).astype(np.float32)
    return (torch.from_numpy(s).to(dev, dtype),
            torch.from_numpy(t).to(dev, dtype), torch.from_numpy(lbl).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("clip_active", [False, True], ids=["t3", "tclip"])
@pytest.mark.parametrize("kl", [True, False], ids=["kl", "ce"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h,w,H,W", [(5, 9, 9, 33, 33), (5, 9, 9, 35, 33),
                                       (21, 17, 13, 65, 50),
                                       (32, 5, 7, 19, 23), (3, 9, 9, 4, 6)])
def test_kernels_match_plain_on_card(cuda, c, h, w, H, W, dtype, kl,
                                     clip_active):
    """Both sides compute in f32 from the same inputs. Where the teacher
    reaches the clip (|t| / T = 1.5e4), one f32 ulp of t / T is ~1e-3, and
    the plain version's interpolation weights (F.interpolate's own, in f32)
    differ from the kernel's tables (the JAX package's, from f64) by an ulp:
    softmax(t / T) then differs by up to ~1e-3 relative, so ds gets an
    absolute budget of 4 ulp(1.5e4) times the KL scale."""
    s, t, lbl = _on_card(cuda, dtype, c, h, w, H, W, clip_active=clip_active)
    t_arg = t if kl else None
    args = (H, W, 2.0, 255, 3e4)
    got = lf.ce_kl_upsampled_fwd(s, t_arg, lbl, *args)
    want = lf.ce_kl_upsampled_fwd_ref(s, t_arg, lbl, *args)
    scales = torch.tensor([0.3, 0.7], device=cuda)
    got_ds = lf.ce_kl_upsampled_bwd(s, t_arg, lbl, scales, *args)
    want_ds = lf.ce_kl_upsampled_bwd_ref(s, t_arg, lbl, scales, *args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert got_ds.dtype == dtype and got_ds.shape == s.shape
    if dtype == torch.bfloat16:      # ds is rounded to bf16 on both sides
        tol = dict(rtol=1e-2, atol=1e-6)
    elif clip_active and kl:
        tol = dict(rtol=1e-4, atol=4 * 2.0 ** -10 * 0.7)
    else:
        tol = dict(rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_ds.float().cpu().numpy(),
                               want_ds.float().cpu().numpy(), **tol)


@pytest.mark.gpu
def test_kernels_are_deterministic_on_card(cuda):
    s, t, lbl = _on_card(cuda, torch.float32, 21, 33, 33, 129, 129, n=4)
    scales = torch.tensor([0.3, 0.7], device=cuda)
    a = lf.ce_kl_upsampled_fwd(s, t, lbl, 129, 129, 4.0, 255, 3e4)
    b = lf.ce_kl_upsampled_fwd(s, t, lbl, 129, 129, 4.0, 255, 3e4)
    da = lf.ce_kl_upsampled_bwd(s, t, lbl, scales, 129, 129, 4.0, 255, 3e4)
    db = lf.ce_kl_upsampled_bwd(s, t, lbl, scales, 129, 129, 4.0, 255, 3e4)
    assert torch.equal(a, b) and torch.equal(da, db)


@pytest.mark.gpu
def test_kernels_reject_what_they_do_not_take(cuda):
    s, t, lbl = _on_card(cuda, torch.float32, 5, 9, 9, 33, 33)
    with pytest.raises(TypeError, match="int64"):
        lf.ce_kl_upsampled_fwd(s, t, lbl.int(), 33, 33, 4.0)
    with pytest.raises(ValueError, match="at most"):
        big = torch.zeros(1, 33, 9, 9, device=cuda)
        lf.ce_kl_upsampled_fwd(big, None, lbl[:1], 33, 33, 4.0)
    with pytest.raises(ValueError, match="contiguous"):
        lf.ce_kl_upsampled_fwd(s.transpose(2, 3), None, lbl, 33, 33, 4.0)
