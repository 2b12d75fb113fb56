"""The port's training slice against the JAX package's.

- ResNet: `ResNet((1, 1, 1, 1))` at OS16 in eval mode with random BN
  statistics gives the JAX module's features at 33² (f32, atol 1e-4), and
  a JAX resnet101's leaves load strictly into the port's.
- One KD step (`make_kd_train_step` with SGD + PolyLR) from the same
  weights: the cheap-conv MobileNetV2 student (head separable-converted) and
  a (1, 1, 1, 1) ResNet DeepLabV3+ teacher, 6 classes, batch 4, 33², f32,
  with hint taps on 'low_level' and 'out' (their 1x1 adapters train in the
  head group). ASPP dropout is off on both sides (the two frameworks draw
  different masks). On the CPU the JAX step takes its plain loss, which
  clips the teacher after the upsample, and the port its fused loss's plain
  version, which clips before it; at these logit sizes the clip never
  binds. loss, task, kd and hint agree at rtol 1e-4; every parameter and
  every BN running mean/var after the step at rtol 1e-3, atol 1e-5; the
  parameters' update within 3x the port's own f32 rounding noise (its
  distance from the f64 update), overall and per tensor (see the test).
- The optimizer's groups and schedules; the training entry point end to
  end on the CPU, with its checkpoint.
"""

import contextlib
import copy
import functools
import io
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import nnx

from kd_cheap_conv_tpu_torch import main as port_main
from kd_cheap_conv_tpu_torch.convert import state_dict_from_jax
from kd_cheap_conv_tpu_torch.models.resnet import ResNet, resnet101
from test_torch_model import jax_leaves, nchw

torch.set_num_threads(1)

C = 6


def _randomize_bn(jm, seed):
    rng = np.random.RandomState(seed)
    for _, m in nnx.iter_modules(jm):
        if isinstance(m, nnx.BatchNorm):
            c = m.mean[...].shape[0]
            m.scale[...] = jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)
            m.bias[...] = jnp.asarray(0.1 * rng.randn(c), jnp.float32)
            m.mean[...] = jnp.asarray(0.1 * rng.randn(c), jnp.float32)
            m.var[...] = jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)


def test_resnet_features_match_jax():
    """The KD test's teacher backbone: ResNet((1, 1, 1, 1)), OS16, random BN
    statistics, eval mode."""
    (_, jt, _), (_, tt, _) = _kd_pair()
    x = np.random.RandomState(2).randn(2, 33, 33, 3).astype(np.float32)
    graphdef, st = nnx.split(jt.backbone)
    want = jax.jit(lambda st, x: nnx.merge(graphdef, st)(x))(st,
                                                             jnp.asarray(x))
    with torch.no_grad():
        got = tt.backbone(nchw(x))
    for k, shape in (("low_level", (2, 256, 9, 9)), ("out", (2, 2048, 3, 3))):
        assert tuple(got[k].shape) == shape
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[k]), rtol=1e-4, atol=1e-4)


def test_resnet101_converts_strictly():
    """Every leaf of a JAX resnet101 maps onto the port's, keys and shapes
    (the leaves are zeros of the abstract shapes: no JAX init needed)."""
    from kd_cheap_conv_tpu.models.resnet import resnet101 as jax_resnet101

    abstract = nnx.eval_shape(lambda: jax_resnet101(rngs=nnx.Rngs(0)))
    flat = nnx.to_flat_state(nnx.state(abstract, nnx.Any(nnx.Param,
                                                          nnx.BatchStat)))
    leaves = {".".join(map(str, p)): np.zeros(v.get_value().shape,
                                              np.float32) for p, v in flat}
    with torch.device("meta"):
        tm = resnet101()
    sd = state_dict_from_jax(leaves)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True, assign=True)
    assert len(tm.layer3) == 23 and tm.layer4[0].conv2.stride == (1, 1)
    assert tm.layer4[1].conv2.dilation == (2, 2)


@functools.cache
def _kd_pair():
    """(JAX student, teacher, adapters), (port student, teacher, adapters),
    with the same weights; the JAX package's default train set-up."""
    from kd_cheap_conv_tpu.kd.distill import HintAdapters as JaxHints
    from kd_cheap_conv_tpu.kd.replace import CheapConvSpec as JaxSpec
    from kd_cheap_conv_tpu.kd.replace import \
        replace_cheap_convs as jax_replace
    from kd_cheap_conv_tpu.models import build_model as jax_build
    from kd_cheap_conv_tpu.models.deeplab import (DeepLabHeadV3Plus,
                                                  SegmentationModel)
    from kd_cheap_conv_tpu.models.layers import set_bn_momentum as jax_mom
    from kd_cheap_conv_tpu.models.resnet import ResNet as JaxResNet
    from kd_cheap_conv_tpu_torch.kd.distill import (HintAdapters,
                                                    make_hint_adapters)
    from kd_cheap_conv_tpu_torch.kd.replace import replace_cheap_convs
    from kd_cheap_conv_tpu_torch.models import build_model
    from kd_cheap_conv_tpu_torch.models.deeplab import \
        DeepLabHeadV3Plus as Head
    from kd_cheap_conv_tpu_torch.models.deeplab import \
        SegmentationModel as Seg
    from kd_cheap_conv_tpu_torch.models.layers import set_bn_momentum

    # initialised under jit: one compile instead of one per parameter shape
    js = nnx.jit(lambda: jax_build("deeplabv3plus_mobilenet", C, 16,
                                   rngs=nnx.Rngs(0)))()
    jax_mom(js.backbone, 0.01)
    jt = nnx.jit(lambda: SegmentationModel(
        JaxResNet((1, 1, 1, 1), output_stride=16, rngs=nnx.Rngs(1)),
        DeepLabHeadV3Plus(2048, 256, C, rngs=nnx.Rngs(2))))()
    _randomize_bn(jt, 3)
    jt.eval()
    jax_replace(js, JaxSpec(), scope="classifier", rngs=nnx.Rngs(5))
    js.classifier.aspp.dropout.rate = 0.0
    ja = JaxHints({"low_level": (24, 256), "out": (320, 2048)},
                  rngs=nnx.Rngs(4))

    ts = build_model("deeplabv3plus_mobilenet", C, 16)
    set_bn_momentum(ts.backbone, 0.01)
    replace_cheap_convs(ts, scope="classifier")
    ts.classifier.aspp.dropout.p = 0.0
    ts.load_state_dict(state_dict_from_jax(jax_leaves(js)), strict=True)
    tt = Seg(ResNet((1, 1, 1, 1), output_stride=16), Head(2048, 256, C))
    tt.load_state_dict(state_dict_from_jax(jax_leaves(jt)), strict=True)
    ta = make_hint_adapters(ts, tt, ("low_level", "out"), input_hw=(33, 33))
    assert isinstance(ta, HintAdapters) and ta.taps == ja.taps
    ta.load_state_dict(state_dict_from_jax(jax_leaves(ja)), strict=True)
    cl = torch.channels_last
    return ((js, jt, ja),
            (ts.to(memory_format=cl), tt.to(memory_format=cl).eval(),
             ta.to(memory_format=cl)))


def _batch(n=4, hw=33, seed=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, hw, hw, 3).astype(np.float32)
    lbl = rng.randint(0, C, (n, hw, hw))
    lbl[0, :5, :7] = 255
    return x, lbl


def _port_kd_step(ts, tt, ta, kw, x, lbl, lr, dtype=torch.float32):
    """One port KD step on copies of the models in `dtype`; returns
    (metrics, {name: (before, after)}, parameter names) for the student
    ('s.') and adapters ('a.')."""
    from kd_cheap_conv_tpu_torch.kd.distill import KDConfig
    from kd_cheap_conv_tpu_torch.train.optim import make_optimizer
    from kd_cheap_conv_tpu_torch.train.steps import make_kd_train_step

    ts, tt, ta = (copy.deepcopy(m).to(dtype) for m in (ts, tt, ta))
    mods = {"s": ts, "a": ta}
    before = {f"{p}.{k}": v.clone() for p, m in mods.items()
              for k, v in m.state_dict().items()}
    params = {f"{p}.{k}" for p, m in mods.items()
              for k, _ in m.named_parameters()}
    named = list(ts.named_parameters()) + [
        (f"adapters.{n}", p) for n, p in ta.named_parameters()]
    opt, sched = make_optimizer(named, lr=lr, max_iters=10)
    step_fn = make_kd_train_step(ts, tt, opt, KDConfig(**kw), sched,
                                 adapters=ta)
    metrics = step_fn(nchw(x).to(dtype), torch.from_numpy(lbl))
    assert float(sched.get_last_lr()[0]) == pytest.approx(
        lr * (1 - 1 / 10) ** 0.9)
    return metrics, {k: (v.double().numpy(), mods[k[0]].state_dict()[k[2:]]
                         .double().numpy())
                     for k, v in before.items()}, params


def _check_kd_step(switches=(), counts=None):
    """One KD step of the JAX package (with the config switches named in
    `switches` on) and of the port from the same weights, held as
    `test_kd_step_matches_jax` says. The JAX models are cloned, so the
    shared pair stays at its initial weights. `counts` (a dict that
    `_count_plain` fills) is cleared before the port's f32 step, after its
    f64 one."""
    from kd_cheap_conv_tpu import config
    from kd_cheap_conv_tpu.kd.distill import KDConfig as JaxKD
    from kd_cheap_conv_tpu.train import make_kd_train_step as jax_step
    from kd_cheap_conv_tpu.train import make_optimizer as jax_opt

    (js, jt, ja), (ts, tt, ta) = _kd_pair()
    js, jt, ja = (nnx.clone(m) for m in (js, jt, ja))
    kw = dict(temperature=2.0, alpha=0.6, beta=0.4, gamma=0.1,
              hint_taps=("low_level", "out"))
    lr = 1e-6
    x, lbl = _batch()

    # JAX: its main.py's optimizer groups over {'student', 'adapters'}
    _, params, _ = nnx.split(js, nnx.Param, ...)
    _, a_params = nnx.split(ja, nnx.Param)
    tx = jax_opt({"student": params, "adapters": a_params}, lr=lr,
                 max_iters=10, label_fn=lambda d: (
                     "backbone" if d.startswith("student.backbone")
                     else "head"))
    old = {s: getattr(config, s) for s in switches}
    try:
        for s in switches:
            setattr(config, s, True)
        init, step, t_state = jax_step(js, jt, tx, JaxKD(**kw), adapters=ja)
        state, jm = step(init(), (jnp.asarray(x), jnp.asarray(lbl, jnp.int32)),
                         t_state)
    finally:
        for s, v in old.items():
            setattr(config, s, v)
    nnx.update(js, state.params["student"], state.rest)
    nnx.update(ja, state.params["adapters"])
    want = {**{f"s.{k}": v.double().numpy() for k, v in state_dict_from_jax(
        jax_leaves(js)).items()}, **{f"a.{k}": v.double().numpy() for k, v in
                                      state_dict_from_jax(
                                          jax_leaves(ja)).items()}}

    _, upd64, _ = _port_kd_step(ts, tt, ta, kw, x, lbl, lr, torch.float64)
    if counts is not None:
        counts.clear()
    got, upd, names = _port_kd_step(ts, tt, ta, kw, x, lbl, lr)
    for k in ("loss", "task", "kd", "hint"):
        np.testing.assert_allclose(float(got[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert set(upd) == set(want)
    for k, w in want.items():
        before, after = upd[k]
        if k.endswith("num_batches_tracked"):    # the JAX BN has none
            assert after == before + 1, k
            continue
        np.testing.assert_allclose(after, w, rtol=1e-3, atol=1e-5, err_msg=k)
    d_got = {k: upd[k][1] - upd[k][0] for k in names}
    d_want = {k: want[k] - upd[k][0] for k in names}
    d_64 = {k: upd64[k][1] - upd64[k][0] for k in names}

    def norm(d):
        return np.sqrt(sum(np.sum(v ** 2) for v in d.values()))

    err = norm({k: d_got[k] - d_want[k] for k in names})
    noise = norm({k: d_got[k] - d_64[k] for k in names})
    assert err <= 3 * noise + 1e-4 * norm(d_want), (err, noise)
    step_max = max(np.abs(d).max() for d in d_want.values())
    for k in names:
        assert np.abs(d_got[k] - d_want[k]).max() <= (
            3 * np.abs(d_got[k] - d_64[k]).max() + 1e-3 * step_max), k
    assert sum(np.abs(d).max() > 0 for d in d_want.values()) > 100


def test_kd_step_matches_jax():
    """Batch 4, not 2: at batch 2 the ASPP pooling branch's train BN sees
    two samples per channel, whose input gradient is exactly zero in exact
    arithmetic and f32 rounding noise in practice, and that noise reaches
    every layer below. Even at batch 4 the train BNs of this random network
    leave the backbone's gradient ill-conditioned: the port's f32 update
    differs from its own f64 update by ~1% (relative L2), and the JAX
    package's by as much. So the update is held to 3x the port's measured
    f32 noise (plus 1e-4 of its norm, and per tensor plus 1e-3 of the
    step's largest entry). The lr (1e-6) keeps every parameter after the
    step within rtol 1e-3, atol 1e-5 as well."""
    _check_kd_step()


def test_kd_step_matches_jax_with_pallas_upsample_and_dw(monkeypatch):
    """The same step with the JAX package's Pallas decoder upsample and
    depthwise conv on (`use_pallas_upsample`, `use_pallas_dw`), held alike.
    The port has no switch: its plain calls in the f32 step show that the
    teacher's and the student's decoder upsample (and the student's
    upsample gradient) and the student's 14 depthwise convs took the new
    path: features[8..17], the ASPP branches' and, as the hint taps keep
    the decoder on its module path, the separable fuse conv's recomputed
    depthwise (forward, dx and dk each)."""
    from test_torch_head import _count_plain

    counts = _count_plain(monkeypatch)
    _check_kd_step(("use_pallas_upsample", "use_pallas_dw"), counts)
    assert {k: counts.get(k, 0) for k in (
        "resize_bilinear_up", "resize_bilinear_up_bwd", "depthwise_conv2d",
        "depthwise_dx", "depthwise_dk")} == {
        "resize_bilinear_up": 2, "resize_bilinear_up_bwd": 1,
        "depthwise_conv2d": 14, "depthwise_dx": 14, "depthwise_dk": 14}, counts


def test_supervised_step_uses_fused_ce_and_learns():
    """make_train_step with cross-entropy takes head-resolution logits into
    the fused CE (beta = 0); its loss equals the plain CE on upsampled
    logits, and a few steps on one batch bring it down."""
    from kd_cheap_conv_tpu_torch.models import build_model
    from kd_cheap_conv_tpu_torch.ops.losses import cross_entropy
    from kd_cheap_conv_tpu_torch.train.optim import make_optimizer
    from kd_cheap_conv_tpu_torch.train.steps import make_train_step

    m = build_model("deeplabv3plus_mobilenet", C, 16).to(
        memory_format=torch.channels_last)
    m.classifier.aspp.dropout.p = 0.0
    opt, sched = make_optimizer(m.named_parameters(), lr=0.001, max_iters=50)
    step = make_train_step(m, opt, sched)
    x, lbl = _batch()
    x, lbl = nchw(x), torch.from_numpy(lbl)
    m.train()
    with torch.no_grad():
        state = {k: v.clone() for k, v in m.state_dict().items()}
        want = cross_entropy(m(x, class_major=True), lbl)
        m.load_state_dict(state)
    losses = [float(step(x, lbl)["loss"]) for _ in range(8)]
    assert losses[0] == pytest.approx(float(want), rel=1e-4)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("policy", ["poly", "step"])
def test_optimizer_groups_and_schedule_match_jax(policy):
    from kd_cheap_conv_tpu.train.optim import poly_schedule, step_schedule
    from kd_cheap_conv_tpu_torch.train.optim import make_optimizer

    named = [("backbone.a", torch.nn.Parameter(torch.ones(2))),
             ("classifier.b", torch.nn.Parameter(torch.ones(3))),
             ("adapters.adapt_out.weight", torch.nn.Parameter(torch.ones(1)))]
    opt, sched = make_optimizer(named, lr=0.1, max_iters=7, lr_policy=policy,
                                step_size=3)
    assert [len(g["params"]) for g in opt.param_groups] == [1, 2]
    ref = (poly_schedule(0.1, 7) if policy == "poly"
           else step_schedule(0.1, 3))
    for i in range(9):
        lr_b, lr_h = (g["lr"] for g in opt.param_groups)
        # the JAX schedules compute in float32
        assert lr_b == pytest.approx(float(ref(i)), rel=1e-6, abs=1e-12)
        assert lr_h == pytest.approx(10 * float(ref(i)), rel=1e-6, abs=1e-12)
        opt.step()
        sched.step()
    assert opt.param_groups[0]["momentum"] == 0.9
    assert opt.param_groups[0]["weight_decay"] == 1e-4


def test_main_trains_kd_and_writes_checkpoint(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_main.main([
            "--kd", "--device", "cpu", "--crop_size", "33", "--total_itrs",
            "2", "--val_interval", "2", "--print_interval", "1",
            "--batch_size", "2", "--val_batch_size", "8", "--num_classes",
            str(C), "--num_workers", "2", "--replace_scope", "classifier",
            "--teacher_model", "deeplabv3plus_resnet50",
            "--ckpt_dir", str(tmp_path)])
    assert rc == 0
    text = out.getvalue()
    assert "replaced 4 convs" in text
    losses = [float(ln.split("loss=")[1].split(",")[0])
              for ln in text.splitlines() if ln.startswith("Itrs")]
    assert len(losses) == 2 and all(map(math.isfinite, losses))
    for prefix in ("latest", "best"):
        ck = torch.load(tmp_path / f"{prefix}_deeplabv3plus_mobilenet_"
                        f"synthetic_os16.pth", weights_only=False)
        assert set(ck) == {"cur_itrs", "model_state", "optimizer_state",
                           "scheduler_state", "best_score"}
        assert ck["cur_itrs"] == 2
        assert ck["scheduler_state"]["last_epoch"] == 2
        assert "classifier.fuse.conv.depthwise.weight" in ck["model_state"]


def test_train_loop_writes_latest_on_sigterm(tmp_path):
    """SIGTERM during a step: the loop finishes that step, writes the
    'latest' checkpoint at its count and returns; no validation runs."""
    import os
    import signal

    from kd_cheap_conv_tpu_torch.train.loop import LoopConfig, train_loop
    from kd_cheap_conv_tpu_torch.train.optim import make_optimizer
    from kd_cheap_conv_tpu_torch.train.steps import TrainState

    model = torch.nn.Linear(2, 2)
    opt, sched = make_optimizer(model.named_parameters(), max_iters=10)
    state = TrainState(model, opt, sched)
    calls = []

    def step_fn(images, labels):
        calls.append(1)
        if len(calls) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return {"loss": torch.tensor(float(len(calls)))}

    def validate_fn(_):
        raise AssertionError("validated before total_itrs")

    batches = iter([(torch.zeros(1, 2), torch.zeros(1))] * 10)
    cfg = LoopConfig(total_itrs=10, print_interval=2, val_interval=100,
                     ckpt_dir=str(tmp_path), model_name="m",
                     dataset_name="d")
    lines = []
    before = signal.getsignal(signal.SIGTERM)
    state, best = train_loop(state=state, step_fn=step_fn, train_iter=batches,
                             cfg=cfg, validate_fn=validate_fn,
                             log_fn=lines.append)
    assert signal.getsignal(signal.SIGTERM) == before
    assert state.step == 3 and best == 0.0
    assert [ln.split(":")[0] for ln in lines] == ["Itrs 2/10", "SIGTERM"]
    ck = torch.load(tmp_path / "latest_m_d_os16.pth", weights_only=False)
    assert ck["cur_itrs"] == 3 and ck["best_score"] == 0.0
    assert sorted(os.listdir(tmp_path)) == ["latest_m_d_os16.pth"]


@pytest.mark.parametrize("flag", [["--ckpt", "x.pth"], ["--teacher_ckpt", "x"],
                                  ["--cached_logits", "x.npz"],
                                  ["--progressive"], ["--continue_training"],
                                  ["--dataset", "voc"]])
def test_main_refuses_queued_paths(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_main.main(["--kd", "--device", "cpu", *flag])
