#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on a CUDA card.

    python3 chip_smoke.py

Drives kd_cheap_conv_tpu_torch (never JAX) on one card, in phases; each
prints its result, and any failure exits non-zero:

1. build       — compile the CUDA kernels from csrc/ (nvcc, sm_90a, one
                 process per source).
2. parity      — kernel A (stride-1 eval IR block) and kernel B (stride-2)
                 on all 17 block geometries of the 513² student at OS16,
                 batch 4, against their plain PyTorch versions, in f32
                 (TF32 off) and bf16.
3. loss_parity — kernel C (fused upsample + CE + KL, forward) and kernel D
                 (its backward) against their plain versions at config #2's
                 shape, (16, 21, 129, 129) -> 513², int64 labels with ~5%
                 void, a teacher spanning +-1e5 (the clip binds), KL and
                 CE-only instances, f32 and bf16 inputs.
4. main        — the serving entry point, `kd_cheap_conv_tpu_torch.main.main`,
                 plain validate and multi-scale + flip TTA at 513² in bf16:
                 a finite mIoU, and exactly 14 kernel-A and 3 kernel-B
                 launches per student forward. Then full-model logits with
                 the kernels against the plain path (the same model with
                 autograd on, where every block runs its own module) in f32,
                 TF32 off.
5. train       — the training entry point, the config-#2 KD command at
                 513², batch 16, bf16, 4 steps, validation at the end:
                 finite losses, exactly one C and one D launch per step, A
                 and B launches in the validation, the latest checkpoint.
6. times       — validate images/s and KD-step images/s on device-resident
                 batches, untraced and before any profiler session; each
                 block's kernel and kernels C and D against their plain
                 versions: device time (torch.profiler, kernels only) and
                 wall time per call (CUDA events); one profiled validate
                 pass and one profiled KD step split by kernel class, with
                 the device's idle share. Printed beside the card's name and
                 power limit.

The teacher of phases 5 and 6 gets seeded random BN affine parameters and
running statistics calibrated on one seeded batch, so that its eval-mode
logits have a trained network's scale (an untrained ResNet-101 in eval mode
reaches |logits| ~ 1e6); the student is as `main` builds it.

The line before the last is the card's `nvidia-smi` name and power limit;
the last line is {"ok": true, "device": {...}}. Without a CUDA card, or
without the rest of the repository beside it, it exits non-zero and prints
no result.
"""

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

MAIN_ARGS = ["--test_only", "--dataset", "synthetic", "--model",
             "deeplabv3plus_mobilenet", "--kd", "--replace_scope",
             "classifier", "--crop_size", "513", "--val_batch_size", "4",
             "--bf16"]
TRAIN_ARGS = ["--kd", "--dataset", "synthetic", "--model",
              "deeplabv3plus_mobilenet", "--teacher_model",
              "deeplabv3plus_resnet101", "--replace_scope", "classifier",
              "--crop_size", "513", "--batch_size", "16", "--bf16",
              "--total_itrs", "4", "--val_interval", "4",
              "--print_interval", "2"]
TEACHER = "deeplabv3plus_resnet101"
TRAIN_STEPS, TRAIN_BATCH = 4, 16
TTA_SCALES = "0.5,1.0,1.5"
N_VAL, BATCH, CROP = 32, 4, 513
HEAD = 129                       # head resolution of a 513² input at OS16
N_CLS = 21
# f32: both sides sum ~1000-term products in different orders (and the
# kernel folds the BNs first); bf16: the plain path rounds every
# intermediate to bf16, the kernel keeps the expand and dw sums in f32.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 1e-1)}
# kernels C/D: both sides compute in f32 from the same inputs (bf16 inputs
# are widened first), so one tolerance serves both dtypes. The teacher here
# sits at the clip, |t|/T = 7500, where one f32 ulp of t/T is ~5e-4 on a
# per-pixel KL of ~3, and the plain interpolation weights (F.interpolate's
# own, f32) differ from the kernel's (the JAX package's tables, f64) by an
# ulp: the sums get rtol 1e-4, and ds an absolute floor of 1e-7
LOSS_TOL = {"values": 1e-4, "ds_rtol": 1e-4, "ds_atol": 1e-7}
SRC = "kd_cheap_conv_tpu_torch/csrc/ir_block_eval.cu"
LOSS_SRC = "kd_cheap_conv_tpu_torch/csrc/ce_kl_upsampled.cu"
KERNEL_NAME = "ir_block_eval_kernel"
LOSS_KERNELS = {"C": "ce_kl_up_fwd_kernel", "D": "ce_kl_up_bwd_kernel"}
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 FLOP/s; the
# special-function unit gives 16 exp results per clock per SM
HBM_BPS, BF16_FLOPS, MUFU_PER_CLK_SM = 3.35e12, 989e12, 16
CONV_WORDS = ("conv", "gemm", "xmma", "nvjet", "cutlass", "implicit",
              "sm90_", "wgrad", "dgrad")
BN_WORDS = ("batch_norm", "batchnorm", "welford", "bn_fw", "bn_bw")


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def smi(query, fmt="csv,noheader"):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           f"--format={fmt}"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def student(dtype=None, seed=1):
    """The student as main builds it, with random BN statistics (so the
    folds are not near-identity), in eval mode on the card."""
    from kd_cheap_conv_tpu_torch.kd.replace import (CheapConvSpec,
                                                    replace_cheap_convs)
    from kd_cheap_conv_tpu_torch.models import build_model

    g = torch.Generator().manual_seed(seed)
    m = build_model("deeplabv3plus_mobilenet", N_CLS, 16, dtype=dtype,
                    generator=g)
    replace_cheap_convs(m, CheapConvSpec(), scope="classifier", generator=g)
    for mod in m.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            c = mod.num_features
            mod.weight.data = 1 + 0.2 * torch.randn(c, generator=g)
            mod.bias.data = 0.1 * torch.randn(c, generator=g)
            mod.running_mean = 0.2 * torch.randn(c, generator=g)
            mod.running_var = 1 + 0.5 * torch.rand(c, generator=g)
    return m.to("cuda", memory_format=torch.channels_last).eval()


def calibrate_bn(model, seed):
    """Seeded random BN affine parameters, then running statistics from one
    train-mode pass (cumulative average, so exactly that batch's moments)
    over two synthetic 513² images, computed on the card; the model is left
    in eval mode on the device it came on."""
    from kd_cheap_conv_tpu_torch.data import SyntheticSegmentation

    g = torch.Generator().manual_seed(seed)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        c = bn.num_features
        bn.weight.data = 1 + 0.2 * torch.randn(c, generator=g)
        bn.bias.data = 0.1 * torch.randn(c, generator=g)
        bn.reset_running_stats()
        bn.momentum = None
    ds = SyntheticSegmentation(N_CLS, size=CROP, length=2, seed=seed)
    x = torch.from_numpy(np.stack([ds[i][0] for i in range(2)]))
    home = next(model.parameters()).device
    model = model.to("cuda").train()
    with torch.no_grad():
        model(x.float().cuda().permute(0, 3, 1, 2))
    for bn in bns:
        bn.momentum = 0.1
    return model.to(home).eval()


@contextlib.contextmanager
def calibrated_teacher_builds():
    """While active, build_model gives the teacher calibrated BN
    statistics (calibrate_bn); every other model is built unchanged."""
    import kd_cheap_conv_tpu_torch.models as models

    orig = models.build_model

    def build(name, *args, **kw):
        m = orig(name, *args, **kw)
        return calibrate_bn(m, seed=7) if name == TEACHER else m

    models.build_model = build
    try:
        yield
    finally:
        models.build_model = orig


def block_inputs(model):
    """[(index, block, input NHWC shape)] for features[1:] at 513², batch 4."""
    h = (CROP - 1) // 2 + 1
    out = []
    for i, f in enumerate(model.backbone.features):
        if i == 0:
            continue
        cin = f.body[0].conv.in_channels
        out.append((i, f, (BATCH, h, h, cin)))
        h = (h - 1) // f.body[-1].conv.stride[0] + 1
    return out


def block_bound_ms(f, shape, esize=2):
    """Least time of one IR block on the card, as (bytes ms, FLOP ms): its
    input and output bytes over HBM and its FLOPs over the bf16 tensor-core
    peak; the bound is the larger of the two."""
    n, h, w, cin = shape
    s = f.body[-1].conv.stride[0]
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    ce = f.body[-1].conv.in_channels
    cout = f.pw_linear.out_channels
    flops = 2 * n * (h * w * cin * ce * (len(f.body) == 2)
                     + ho * wo * (9 * ce + ce * cout))
    nbytes = esize * n * (h * w * cin + ho * wo * cout)
    return nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3


def cuda_ms(fn, iters=20):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(kernel, plain, name=KERNEL_NAME, iters=10, rounds=3):
    """Device time per call (ms) of each: our kernel's launches against
    every kernel the plain version runs, summed from torch.profiler. The
    median of three profiled rounds, because a round now and then loses
    its device events (2 of ~600 read 0 on an H100)."""
    runs = []
    for _ in range(rounds):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in (kernel, plain):
                for _ in range(iters):
                    fn()
            torch.cuda.synchronize()
        ours = total = 0.0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                total += e.device_time_total
                if name in e.key:
                    ours += e.device_time_total
        runs.append((ours / iters / 1e3, (total - ours) / iters / 1e3))
    return (statistics.median(r[0] for r in runs),
            statistics.median(r[1] for r in runs))


def paired_ms(kernel, plain, reps=5):
    """Median ms per call of each, timed in turns (plain, kernel, kernel,
    plain) so that clock and neighbour drift hits both alike."""
    for fn in (plain, kernel):
        cuda_ms(fn, iters=3)
    tk, tp = [], []
    for _ in range(reps):
        tp.append(cuda_ms(plain))
        tk.append(cuda_ms(kernel))
        tk.append(cuda_ms(kernel))
        tp.append(cuda_ms(plain))
    return statistics.median(tk), statistics.median(tp)


def run_main(extra):
    from kd_cheap_conv_tpu_torch import main as port_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_main.main(MAIN_ARGS + extra)
    torch.cuda.synchronize()
    text = out.getvalue()
    sys.stdout.write(text)
    if rc != 0:
        raise SystemExit(f"main returned {rc}")
    miou = float(text.split("Mean IoU:")[1].split()[0])
    if not math.isfinite(miou):
        raise SystemExit(f"main: Mean IoU is {miou}")
    return miou


def loss_inputs(dtype, g):
    """Config #2's loss inputs: head-resolution student logits ~N(0, 4),
    a teacher spanning +-1e5 (so the 3e4 clip binds), int64 labels with
    ~5% void."""
    n, shape = TRAIN_BATCH, (TRAIN_BATCH, N_CLS, HEAD, HEAD)
    s = (2.0 * torch.randn(shape, device="cuda", generator=g)).to(dtype)
    t = (1e5 * (2 * torch.rand(shape, device="cuda", generator=g) - 1)
         ).to(dtype)
    lbl = torch.randint(0, N_CLS, (n, CROP, CROP), device="cuda",
                        generator=g)
    void = torch.rand((n, CROP, CROP), device="cuda", generator=g) < 0.05
    return s, t, lbl.masked_fill(void, 255)


def loss_scales(lbl, temperature=4.0, alpha=0.5, beta=0.5):
    """The grad scales (a, k) the autograd backward folds for d total."""
    valid = (lbl != 255).sum().float().clamp_min(1.0)
    return torch.stack([alpha / valid,
                        torch.tensor(beta * temperature / lbl.numel(),
                                     device=lbl.device)]).float()


def loss_bound_ms(kernel, s, t, lbl, sm_clock_mhz, sms):
    """Least time of kernel C or D on the card: the larger of the bytes it
    must move (logits and labels read once, partials or ds written once)
    over HBM, and its exponentials (softmax of s, s/T and t/T: three per
    class and pixel) over the special-function units."""
    n, c = s.shape[:2]
    nbytes = (s.numel() + (t.numel() if t is not None else 0)) \
        * s.element_size() + lbl.numel() * lbl.element_size()
    nbytes += s.numel() * s.element_size() if kernel == "D" else 0
    exps = (3 if t is not None else 1) * n * c * lbl.shape[1] * lbl.shape[2]
    t_bytes = nbytes / HBM_BPS
    t_ops = exps / (MUFU_PER_CLK_SM * sms * sm_clock_mhz * 1e6)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kd_setup(seed=1):
    """Student, calibrated teacher, optimizer and KD step as main builds
    them for config #2 (bf16, 513², batch 16)."""
    from kd_cheap_conv_tpu_torch.kd.distill import KDConfig
    from kd_cheap_conv_tpu_torch.kd.replace import (CheapConvSpec,
                                                    replace_cheap_convs)
    from kd_cheap_conv_tpu_torch.models import build_model
    from kd_cheap_conv_tpu_torch.models.layers import set_bn_momentum
    from kd_cheap_conv_tpu_torch.train.optim import make_optimizer
    from kd_cheap_conv_tpu_torch.train.steps import make_kd_train_step

    g = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16
    model = build_model("deeplabv3plus_mobilenet", N_CLS, 16, dtype=bf16,
                        generator=g)
    set_bn_momentum(model.backbone, 0.01)
    teacher = calibrate_bn(build_model(
        TEACHER, N_CLS, 16, dtype=bf16,
        generator=torch.Generator().manual_seed(seed + 1)), seed=7)
    replace_cheap_convs(model, CheapConvSpec(), scope="classifier",
                        generator=g)
    model = model.to("cuda", memory_format=torch.channels_last)
    teacher = teacher.to("cuda", memory_format=torch.channels_last).eval()
    opt, sched = make_optimizer(model.named_parameters(), lr=0.01,
                                max_iters=1000)
    return model, teacher, make_kd_train_step(model, teacher, opt,
                                              KDConfig(), sched)


def classify(name):
    name = name.lower()
    if any(v in name for v in LOSS_KERNELS.values()):
        return "loss_CD"
    if any(w in name for w in BN_WORDS):
        return "bn"
    if any(w in name for w in CONV_WORDS):
        return "convs"
    return "other"


def device_split(fn):
    """Device ms of one call of fn by kernel class (torch.profiler), and the
    largest kernels of the 'other' class as (name, ms, calls)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split = {"loss_CD": 0.0, "convs": 0.0, "bn": 0.0, "other": 0.0}
    other = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            part = classify(e.key)
            split[part] += e.device_time_total / 1e3
            if part == "other":
                other.append((e.key[:60], round(e.device_time_total / 1e3, 3),
                              e.count))
    return split, sorted(other, key=lambda o: -o[1])[:8]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from kd_cheap_conv_tpu_torch import native
    from kd_cheap_conv_tpu_torch.ops import irchain_eval as ire
    from kd_cheap_conv_tpu_torch.ops import losses_fused as lf

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi("name,power.limit")
    sm_clock = float(smi("clocks.max.sm", "csv,noheader,nounits"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kernels = {"A": ire.fused_mnv2_blocks_eval, "B": ire.fused_ir_block_s2_eval,
               "C": lf.ce_kl_upsampled_fwd, "D": lf.ce_kl_upsampled_bwd}
    refs = {"A": lambda x, f: ire.fused_mnv2_blocks_eval_ref(x, (f,)),
            "B": ire.fused_ir_block_s2_eval_ref}
    launch = {"A": lambda x, f: ire.fused_mnv2_blocks_eval(x, (f,)),
              "B": ire.fused_ir_block_s2_eval}

    # 1. build
    lib, seconds, log = native.build()
    native.library()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "Used" in ln or "spill" in ln]
    phase("build", library=lib.name, seconds=round(seconds, 2),
          compiled=bool(log), ptxas=ptxas)

    # 2. kernel parity on the 17 geometries
    model = student()
    blocks = block_inputs(model)
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = {(k, dt): 0.0 for k in "ABCD"
             for dt in (torch.float32, torch.bfloat16)}
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = TOL[dtype]
        for i, f, shape in blocks:
            k = "A" if ire.ir_block_fusable(f) else "B"
            x = torch.randn(shape, device="cuda", generator=g).to(dtype)
            with torch.no_grad():
                got = launch[k](x, f).float()
                want = refs[k](x, f).float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            ok = bool((err <= atol + rtol * want.abs()).all())
            worst[k, dtype] = max(worst[k, dtype], float(err.max()))
            phase("parity", kernel=k, block=f"f{i}", shape=list(shape),
                  dtype=str(dtype)[6:], max_abs_err=float(err.max()),
                  rtol=rtol, atol=atol, ok=ok)
            if not ok:
                raise SystemExit(f"parity failed: kernel {k} on f{i} {dtype}")
    n_a = sum(ire.ir_block_fusable(f) for _, f, _ in blocks)
    n_b = sum(ire.ir_block_s2_fusable(f) for _, f, _ in blocks)
    if (n_a, n_b) != (14, 3):
        raise SystemExit(f"expected 14 stride-1 and 3 stride-2 blocks, "
                         f"got {n_a} and {n_b}")

    # 3. kernels C and D against their plain versions at config #2's shape
    loss_args = (CROP, CROP, 4.0, 255, 3e4)
    for dtype in (torch.float32, torch.bfloat16):
        s, t, lbl = loss_inputs(dtype, g)
        scales = loss_scales(lbl)
        for with_kl in (True, False):
            tt = t if with_kl else None
            got = lf.ce_kl_upsampled_fwd(s, tt, lbl, *loss_args)
            want = lf.ce_kl_upsampled_fwd_ref(s, tt, lbl, *loss_args)
            ds = lf.ce_kl_upsampled_bwd(s, tt, lbl, scales, *loss_args)
            ds_ref = lf.ce_kl_upsampled_bwd_ref(s, tt, lbl, scales,
                                                *loss_args)
            torch.cuda.synchronize()
            verr = float(((got - want).abs() / want.abs().clamp_min(1.0))
                         .max())
            derr = (ds.float() - ds_ref.float()).abs()
            ok = (verr <= LOSS_TOL["values"] and bool(
                (derr <= LOSS_TOL["ds_atol"] + LOSS_TOL["ds_rtol"]
                 * ds_ref.float().abs()).all()))
            npix = lbl.numel()
            losses_k = [got[0] / got[1].clamp_min(1), 16.0 * got[2] / npix]
            losses_p = [want[0] / want[1].clamp_min(1),
                        16.0 * want[2] / npix]
            worst["C", dtype] = max(worst["C", dtype], *(
                float((a - b).abs()) for a, b in zip(losses_k, losses_p)))
            worst["D", dtype] = max(worst["D", dtype], float(derr.max()))
            phase("loss_parity", instance="kl" if with_kl else "ce",
                  dtype=str(dtype)[6:], shape=list(s.shape), out=[CROP, CROP],
                  sums=got.tolist(), sums_plain=want.tolist(),
                  values_rel_err=verr, ds_max_abs_err=float(derr.max()),
                  ds_max_abs=float(ds_ref.float().abs().max()),
                  tol=LOSS_TOL, ok=ok)
            if not ok:
                raise SystemExit(f"loss parity failed ({dtype}, "
                                 f"{'kl' if with_kl else 'ce'})")
    del s, t, lbl, ds, ds_ref

    # 4. the serving path, counted from zero
    forwards = math.ceil(N_VAL / BATCH)
    launches = {k: 0 for k in kernels}
    for extra, fwd in (([], forwards),
                       (["--tta", "--tta_scales", TTA_SCALES],
                        forwards * len(TTA_SCALES.split(",")))):
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        miou = run_main(extra)
        wall = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in kernels.items()}
        phase("main", args=" ".join(extra) or "validate", mean_iou=miou,
              forwards=fwd, launches_A=got["A"], launches_B=got["B"],
              wall_s=round(wall, 2))
        if got != {"A": 14 * fwd, "B": 3 * fwd, "C": 0, "D": 0}:
            raise SystemExit(f"expected {14 * fwd} A and {3 * fwd} B "
                             f"launches, got {got}")
        for k in "AB":
            launches[k] += got[k]

    from kd_cheap_conv_tpu_torch.data import SyntheticSegmentation

    val = SyntheticSegmentation(N_CLS, size=CROP, length=N_VAL, seed=2)
    imgs = torch.stack([torch.from_numpy(val[i][0]) for i in range(2)])
    x = imgs.float().cuda().permute(0, 3, 1, 2)
    with torch.no_grad():
        fused = model(x)
    plain = model(x).detach()
    torch.cuda.synchronize()
    err = float((fused - plain).abs().max())
    scale = float(plain.abs().max())
    agree = float((fused.argmax(1) == plain.argmax(1)).float().mean())
    phase("logits", shape=list(fused.shape), max_abs_err=err,
          max_abs_logit=scale, argmax_agree=agree)
    if not (torch.isfinite(fused).all() and err <= 1e-3 * max(1.0, scale)
            and agree >= 0.999):
        raise SystemExit("full-model logits: kernel path and plain path "
                         "disagree")
    del model, fused, plain

    # 5. the training path (config #2 KD, 4 steps), counted from zero
    from kd_cheap_conv_tpu_torch import main as port_main

    with tempfile.TemporaryDirectory() as ckpt_dir:
        for fn in kernels.values():
            fn.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with calibrated_teacher_builds(), contextlib.redirect_stdout(out):
            rc = port_main.main(TRAIN_ARGS + ["--ckpt_dir", ckpt_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in kernels.items()}
        text = out.getvalue()
        sys.stdout.write(text)
        ckpts = sorted(os.listdir(ckpt_dir))
    losses = [float(line.split("loss=")[1].split(",")[0])
              for line in text.splitlines() if line.startswith("Itrs")]
    phase("train", args=" ".join(TRAIN_ARGS), wall_s=round(wall, 2),
          launches=got, losses=losses, checkpoints=ckpts)
    latest = "latest_deeplabv3plus_mobilenet_synthetic_os16.pth"
    if rc != 0 or not losses or not all(map(math.isfinite, losses)):
        raise SystemExit(f"train: rc {rc}, losses {losses}")
    if got["C"] != TRAIN_STEPS or got["D"] != TRAIN_STEPS:
        raise SystemExit(f"train: expected {TRAIN_STEPS} C and D launches "
                         f"(one each per step), got {got}")
    if got["A"] != 14 * forwards or got["B"] != 3 * forwards:
        raise SystemExit(f"train: the validation at the end ran "
                         f"{got['A']} A and {got['B']} B launches")
    if latest not in ckpts:
        raise SystemExit(f"train: no {latest} in {ckpts}")
    for k in "CD":
        launches[k] = got[k]

    # 6. times: validate and the KD step first, untraced and before any
    # torch.profiler session (one such session slowed later passes by ~4%
    # on an H100 host)
    from kd_cheap_conv_tpu_torch.train.loop import validate

    bf16_model = student(torch.bfloat16)
    batches = []
    for s in range(0, N_VAL, BATCH):
        im, lb = zip(*(val[i] for i in range(s, s + BATCH)))
        batches.append((torch.from_numpy(np.stack(im)).float().cuda()
                        .permute(0, 3, 1, 2),
                        torch.from_numpy(np.stack(lb)).long().cuda()))
    validate(bf16_model, batches, num_classes=N_CLS)            # warm-up
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        validate(bf16_model, batches, num_classes=N_CLS)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = statistics.quantiles(walls, n=4)
    phase("validate_rate", images=N_VAL, batch=BATCH, dtype="bfloat16",
          passes=len(walls), median_img_per_s=round(N_VAL / med * 1e3, 2),
          q1_img_per_s=round(N_VAL / q3 * 1e3, 2),
          q3_img_per_s=round(N_VAL / q1 * 1e3, 2),
          median_pass_ms=round(med, 3),
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 2**30, 2),
          card=card)

    train_ds = SyntheticSegmentation(N_CLS, size=CROP, length=TRAIN_BATCH,
                                     seed=1)
    im, lb = zip(*(train_ds[i] for i in range(TRAIN_BATCH)))
    t_images = (torch.from_numpy(np.stack(im)).float().cuda()
                .permute(0, 3, 1, 2))
    t_labels = torch.from_numpy(np.stack(lb)).long().cuda()
    kd_student, kd_teacher, kd_step = kd_setup()
    for _ in range(3):                                         # warm-up
        kd_step(t_images, t_labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(12):
        t0 = time.perf_counter()
        metrics = kd_step(t_images, t_labels)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    sq1, smed, sq3 = statistics.quantiles(steps, n=4)
    with torch.no_grad():
        t_small = kd_teacher(t_images, class_major=True, upsample=False)
    phase("train_rate", what="KD step, 513², batch 16, bf16, "
          "device-resident batch", steps=len(steps),
          median_img_per_s=round(TRAIN_BATCH / smed * 1e3, 2),
          q1_img_per_s=round(TRAIN_BATCH / sq3 * 1e3, 2),
          q3_img_per_s=round(TRAIN_BATCH / sq1 * 1e3, 2),
          median_step_ms=round(smed, 3),
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 2**30, 2),
          loss=float(metrics["loss"]),
          teacher_max_abs_logit=float(t_small.float().abs().max()),
          card=card)

    # per block, bf16 (the serving dtype) and f32
    total = {}
    # per kernel: [sum of per-block bounds, bytes ms, FLOP ms]
    bound = {"A": [0.0, 0.0, 0.0], "B": [0.0, 0.0, 0.0]}
    for dtype in (torch.bfloat16, torch.float32):
        for i, f, shape in blocks:
            k = "A" if ire.ir_block_fusable(f) else "B"
            x = torch.randn(shape, device="cuda", generator=g).to(dtype)
            with torch.no_grad():
                kfn, pfn = (lambda: launch[k](x, f)), (lambda: refs[k](x, f))
                w_ker, w_ref = paired_ms(kfn, pfn)
                t_ker, t_ref = device_ms(kfn, pfn)
            b_bytes, b_ops = block_bound_ms(f, shape)
            phase("block_time", kernel=k, block=f"f{i}", dtype=str(dtype)[6:],
                  ms=round(t_ker, 4), plain_ms=round(t_ref, 4),
                  wall_ms=round(w_ker, 4), plain_wall_ms=round(w_ref, 4),
                  bound_ms=round(max(b_bytes, b_ops), 5)
                  if dtype == torch.bfloat16 else None)
            tk, tr = total.get((k, dtype), (0.0, 0.0))
            total[k, dtype] = (tk + t_ker, tr + t_ref)
            if dtype == torch.bfloat16:
                bound[k][0] += max(b_bytes, b_ops)
                bound[k][1] += b_bytes
                bound[k][2] += b_ops
    # kernels C and D at config #2 (bf16 logits, the main path's)
    s, t, lbl = loss_inputs(torch.bfloat16, g)
    s, t = s.contiguous(), t_small.contiguous()
    scales = loss_scales(lbl)
    calls = {
        "C": (lambda: lf.ce_kl_upsampled_fwd(s, t, lbl, *loss_args),
              lambda: lf.ce_kl_upsampled_fwd_ref(s, t, lbl, *loss_args)),
        "D": (lambda: lf.ce_kl_upsampled_bwd(s, t, lbl, scales, *loss_args),
              lambda: lf.ce_kl_upsampled_bwd_ref(s, t, lbl, scales,
                                                 *loss_args))}
    for k, (kfn, pfn) in calls.items():
        w_ker, w_ref = paired_ms(kfn, pfn, reps=3)
        t_ker, t_ref = device_ms(kfn, pfn, name=LOSS_KERNELS[k], iters=5)
        b_ms, b_by = loss_bound_ms(k, s, t, lbl, sm_clock, sms)
        total[k, torch.bfloat16] = (t_ker, t_ref)
        bound[k] = [b_ms] + ([1.0, 0.0] if b_by == "bytes" else [0.0, 1.0])
        phase("loss_time", kernel=k, shape=list(s.shape), out=[CROP, CROP],
              dtype="bfloat16", ms=round(t_ker, 4), plain_ms=round(t_ref, 4),
              wall_ms=round(w_ker, 4), plain_wall_ms=round(w_ref, 4),
              bound_ms=round(b_ms, 5), bound_by=b_by,
              sm_clock_max_mhz=sm_clock, card=card)
    del s, t, lbl

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        validate(bf16_model, batches, num_classes=N_CLS)
        torch.cuda.synchronize()
    split = {"ir_blocks": 0.0, "convs": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.key.lower()
        part = ("ir_blocks" if KERNEL_NAME in name else
                "convs" if any(w in name for w in ("conv", "gemm", "xmma",
                                                   "nvjet", "cutlass"))
                else "other")
        split[part] += e.device_time_total / 1e3
    busy = sum(split.values())
    # idle share against the untraced median pass: tracing slows the host
    phase("profile", what="validate, 8 batches of 4 at 513², bf16",
          device_ms={k: round(v, 3) for k, v in split.items()},
          untraced_pass_ms=round(med, 3),
          device_idle_share=round(1 - busy / med, 3) if busy else None)

    # one KD step by kernel class; the teacher's forward alone is profiled
    # too, so that its convs can be told from the student's
    del bf16_model, batches
    with torch.no_grad():
        teacher_split, _ = device_split(lambda: kd_teacher(
            t_images, class_major=True, upsample=False))
    step_split, top_other = device_split(lambda: kd_step(t_images, t_labels))
    step_busy = sum(step_split.values())
    kd_split = {"loss_CD": step_split["loss_CD"],
                "teacher_convs": teacher_split["convs"],
                "student_convs": step_split["convs"] - teacher_split["convs"],
                "bn": step_split["bn"], "other": step_split["other"]}
    phase("train_profile", what="one KD step, 513², batch 16, bf16",
          device_ms={k: round(v, 3) for k, v in kd_split.items()},
          teacher_forward_ms={k: round(v, 3)
                              for k, v in teacher_split.items()},
          top_other=top_other, device_busy_ms=round(step_busy, 3),
          untraced_step_ms=round(smed, 3),
          device_idle_share=round(1 - step_busy / smed, 3)
          if step_busy else None, card=card)

    entries = {"A": ("fused_mnv2_blocks_eval", SRC,
                     "kd_cheap_conv_tpu/ops/pallas/irchain.py:548"),
               "B": ("fused_ir_block_s2_eval", SRC,
                     "kd_cheap_conv_tpu/ops/pallas/irchain.py:586"),
               "C": ("fused_ce_kl_loss_upsampled (forward)", LOSS_SRC,
                     "kd_cheap_conv_tpu/ops/pallas/losses.py:537"),
               "D": ("fused_ce_kl_loss_upsampled (backward)", LOSS_SRC,
                     "kd_cheap_conv_tpu/ops/pallas/losses.py:537")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": where,
         "launches": launches[k],
         "max_abs_err": worst[k, torch.float32],
         "max_abs_err_bf16": worst[k, torch.bfloat16],
         "ms": round(total[k, torch.bfloat16][0], 4),
         "plain_ms": round(total[k, torch.bfloat16][1], 4),
         "bound_ms": round(bound[k][0], 5),
         "bound_by": "bytes" if bound[k][1] >= bound[k][2] else "operations",
         "library_ms": None}
        for k, (name, src, where) in entries.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
