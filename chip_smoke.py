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
4. chain_parity — the six BN-barrier pass kernels (csrc/bn_passes.cu)
                 against their plain versions at every geometry of the
                 config-#2 path (17 forward and 17 backward passes of the
                 train-mode stem and IR chain at batch 16, 513²), f32 (TF32
                 off) and bf16.
   entry_parity — the four image-entry kernels (csrc/entry_convs.cu: the
                 student's entry conv forward, weight and image gradient,
                 the teacher's eval stem + maxpool) against their plain
                 versions at config #2's shapes (16 x 513² x 3), f32 and
                 bf16, the weight gradient twice, bit for bit, and the image
                 gradient also at an odd-by-even size; then features[0..6]
                 from the image through the chains (the entry-conv kernels
                 included) against `_forward_modules` in f32 (values,
                 gradients, batch and running statistics), and the chains'
                 backward run twice, bit for bit.
   head_parity — the five head kernels (csrc/head_convs.cu: the separable
                 conv of the three ASPP branches, 16 x 33² x 320 -> 256 at
                 dilations 6, 12, 18, and the fused decoder head's passes
                 P1, P2, B1, B2 at 16 x 129², 48 + 256 -> 256 -> 21 classes;
                 the separable conv also at the serving fuse conv, 4 x 129²
                 x 304 -> 256, dilation 1) against their plain versions,
                 f32 (TF32 off) and bf16 (the separable conv to one ulp of
                 its output), the
                 weight gradients twice, bit for bit; then the whole head
                 forward and backward through the kernels against the
                 module path with stock convs and upsample in f32 and f64.
   resample_dw_parity — the decoder upsample's two kernels and the three
                 depthwise kernels (csrc/resample_dw.cu) against their plain
                 versions: the upsample at 16 and 4 x 33² x 256 -> 129², the
                 depthwise conv, dx and dk at each of the 13 depthwise
                 geometries of the KD step (features[8..17] and the three
                 ASPP branches, read from the student's forward), f32 (TF32
                 off, 1e-5 of the largest value) and bf16 (one ulp), dk
                 twice, bit for bit.
5. main        — the serving entry point, `kd_cheap_conv_tpu_torch.main.main`,
                 plain validate and multi-scale + flip TTA at 513² in bf16:
                 a finite mIoU, exactly 14 kernel-A, 3 kernel-B, 4
                 separable and 1 upsample launches per student forward and
                 no pass, entry, decoder, upsample-gradient or depthwise
                 launch. Then full-model
                 logits with the kernels against the plain path (the same
                 model with autograd on, where every block runs its own
                 module, and its separable convs, depthwise convs and
                 upsample on cuDNN and F.interpolate: no kernel of the port
                 launches) in f32, TF32 off.
6. train       — the training entry point, the config-#2 KD command at
                 513², batch 16, bf16, 4 steps, validation at the end:
                 finite losses, exactly one C and one D launch, 11 / 4 / 2
                 launches of each forward and backward pass kernel (1x1 /
                 depthwise / depthwise stride 2), one entry-conv forward,
                 one entry-conv weight gradient, no image gradient and one
                 teacher-stem launch per step, 3 separable launches and one
                 of each decoder pass per step, 2 upsample, 1 upsample-
                 gradient and 13 each of the depthwise conv, dx and dk
                 launches per step, A, B, separable and upsample launches
                 in the validation, the latest checkpoint; and no convolution with
                 a 3-channel input left in a profiled KD step.
7. times       — validate images/s and KD-step images/s on device-resident
                 batches, untraced and before any profiler session; each
                 block's kernel, kernels C and D (KL and CE-only), the
                 pass kernels at each of their geometries and the entry
                 kernels against their plain versions (the entry kernels
                 also against the stock sequences they replace): device
                 time (torch.profiler) and, for A-D, wall time per call
                 (CUDA events); features[0..6] forward and backward from
                 the image, the chains with the entry-conv kernels against
                 the cuDNN entry conv + chains and against the module path,
                 the head kernels against their plain versions and the
                 stock sequences they replace, the whole head forward and
                 backward against the module path (`head_time`), the
                 upsample and depthwise kernels summed per KD step against
                 their plain versions and the one PyTorch call computing
                 each (`resample_dw_time`),
                 and the teacher's forward with and without its stem kernel
                 (CUDA events, in turns); one profiled validate pass and one
                 profiled KD step split by kernel class, with the device's
                 idle share (the step's profile must hold every kernel of
                 the port it launches, as often as it launches it).
                 Printed beside the card's name and power limit.

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
import copy
import functools
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

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
PASS_SRC = "kd_cheap_conv_tpu_torch/csrc/bn_passes.cu"
# pass kernel: (its kernel function in PASS_SRC, launches per KD step, the
# TPU kernel it replaces)
PASSES = {
    "bn_pw": ("bn_pw_fwd_kernel", 11,
              "kd_cheap_conv_tpu/ops/pallas/stem.py:321"),
    "bn_dw": ("bn_dw_fwd_kernel", 4,
              "kd_cheap_conv_tpu/ops/pallas/stem.py:302"),
    "bn_dw_s2": ("bn_dw_fwd_kernel", 2,
                 "kd_cheap_conv_tpu/ops/pallas/stem.py:338"),
    "pw_bwd": ("pw_bwd_kernel", 11,
               "kd_cheap_conv_tpu/ops/pallas/stem.py:776"),
    "dw_bwd": ("dw_bwd_kernel", 4,
               "kd_cheap_conv_tpu/ops/pallas/stem.py:824"),
    "dw_s2_bwd": ("dw_bwd_kernel", 2,
                  "kd_cheap_conv_tpu/ops/pallas/stem.py:914")}
# pass kernels vs plain, max abs error over max |plain| per output: f32,
# both sides sum in other orders (1x1: <= 192 terms; dW, dk and the moments
# over up to 1.06 M pixels); bf16, y and gy_k are rounded to bf16 (1 ulp =
# 2^-8 relative) and the 1x1 operands are rounded where a last-ulp f32
# difference can round them apart. The BN arithmetic is rounded alike on
# both sides, so the relu6 masks agree bit for bit.
PASS_TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
# features[0..6] in f32 against the module path in f64: values relative L2
# 1e-5 (both f32 paths measured ~1.3e-6 on an H100), batch statistics max
# abs error over max |f64| per BN 1e-4 (chains vs modules 1.8e-6). Gradients: the
# train-mode backward through five BN layers is ill-conditioned, both f32
# paths sit ~1.5e-3 (relative L2) from f64, so the chains' error per tensor
# must stay within 3x the module path's (measured at most 2.1x)
FEAT_TOL = {"values": 1e-5, "stats": 1e-4, "grads_vs_noise": 3.0}
ENTRY_SRC = "kd_cheap_conv_tpu_torch/csrc/entry_convs.cu"
# entry kernel: (its kernel function in ENTRY_SRC, launches per KD step, the
# TPU kernel it replaces)
ENTRY = {
    "f0": ("f0_fwd_kernel", 1, "kd_cheap_conv_tpu/ops/pallas/stem.py:441"),
    "f0_wgrad": ("f0_wgrad_kernel", 1,
                 "kd_cheap_conv_tpu/ops/pallas/stem.py:488"),
    "f0_xgrad": ("f0_xgrad_kernel", 0,
                 "kd_cheap_conv_tpu/ops/pallas/stem.py:508"),
    "tstem": ("tstem_kernel", 1, "kd_cheap_conv_tpu/ops/pallas/tstem.py:80")}
HEAD_SRC = "kd_cheap_conv_tpu_torch/csrc/head_convs.cu"
# head kernel: (its kernel function in HEAD_SRC, launches per KD step, the
# TPU kernel it replaces); "sep" is the separable conv of the three ASPP
# branches, the other four the fused decoder head's passes P1, P2, B1, B2
HEAD_KERNELS = {
    "sep": ("sep_fwd_kernel", 3,
            "kd_cheap_conv_tpu/ops/pallas/separable.py:67"),
    "sep_fwd": ("sep_fwd_kernel", 1,
                "kd_cheap_conv_tpu/ops/pallas/decoder.py:59"),
    "head_fwd": ("head_fwd_kernel", 1,
                 "kd_cheap_conv_tpu/ops/pallas/decoder.py:83"),
    "head_bwd": ("head_bwd_kernel", 1,
                 "kd_cheap_conv_tpu/ops/pallas/decoder.py:100"),
    "sep_bwd": ("sep_bwd_kernel", 1,
                "kd_cheap_conv_tpu/ops/pallas/decoder.py:138")}
# config #2's head: low-level 48 + upsampled ASPP 256 channels at 129²,
# Cm 256; the ASPP branches 320 -> 256 at 33², dilations 6, 12, 18
CL, CU, CM, ASPP_HW, ASPP_C, ASPP_DIL = 48, 256, 256, 33, 320, (6, 12, 18)
# head kernels vs plain: values and weight gradients as the pass kernels
# (PASS_TOL), but the separable conv in bf16 to one ulp of its output (it
# multiplies the f32 depthwise output, as its plain version does); the
# batch moments and the BN-backward sums, taken in f32 on both sides, 1e-4
# relative to their largest entry in either dtype
HEAD_SUM_TOL = 1e-4
RESAMPLE_SRC = "kd_cheap_conv_tpu_torch/csrc/resample_dw.cu"
# upsample / depthwise kernel: (its kernel function in RESAMPLE_SRC,
# launches per KD step, the TPU kernel it replaces). up_fwd: the teacher's
# and the student's decoder; dw_conv, dw_dx, dw_dk: the 10 stride-1
# depthwise convs of the student's features[8..17] and the three ASPP
# branches' recomputed depthwise in the separable conv's backward
RESAMPLE_KERNELS = {
    "up_fwd": ("up_fwd_kernel", 2,
               "kd_cheap_conv_tpu/ops/pallas/upsample.py:85"),
    "up_bwd": ("up_bwd_kernel", 1,
               "kd_cheap_conv_tpu/ops/pallas/upsample.py:99"),
    "dw_conv": ("dw_conv_kernel", 13,
                "kd_cheap_conv_tpu/ops/pallas/dwconv.py:79"),
    "dw_dx": ("dw_conv_kernel", 13,
              "kd_cheap_conv_tpu/ops/pallas/dwconv.py:89"),
    "dw_dk": ("dw_dk_kernel", 13,
              "kd_cheap_conv_tpu/ops/pallas/dwconv.py:98")}
# upsample and depthwise kernels vs plain: f32 max abs error 1e-5 of the
# largest plain magnitude (both sides take the same products and sums, dk
# in another order); bf16 one ulp of the largest plain magnitude (both
# round at the JAX kernels' points)
RESAMPLE_TOL = 1e-5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 FLOP/s, f32
# FLOP/s outside the tensor cores; the special-function unit gives 16 exp
# results per clock per SM
HBM_BPS, BF16_FLOPS, F32_FLOPS, MUFU_PER_CLK_SM = 3.35e12, 989e12, 67e12, 16
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
    if any(v[0] in name for v in RESAMPLE_KERNELS.values()):
        return "resample_dw"
    if any(v[0] in name for v in HEAD_KERNELS.values()):
        return "head"
    if any(v[0] in name for v in PASSES.values()):
        return "bn_passes"
    if any(v[0] in name for v in ENTRY.values()):
        return "entry"
    if any(w in name for w in BN_WORDS):
        return "bn"
    if any(w in name for w in CONV_WORDS):
        return "convs"
    return "other"


def step_kernel_launches():
    """Launches of each of the port's kernel functions in one KD step."""
    want = {v: 1 for v in LOSS_KERNELS.values()}
    for table in (PASSES, ENTRY, HEAD_KERNELS, RESAMPLE_KERNELS):
        for name, per_step, _ in table.values():
            want[name] = want.get(name, 0) + per_step
    return {k: v for k, v in want.items() if v}


def device_split(fn, want, rounds=3):
    """Device ms of one call of fn by kernel class (torch.profiler), the
    largest kernels of the 'other' class as (name, ms, calls), and the
    number of profiled rounds it took. Each round records the second of two
    calls (the first is the profiler's warm-up). A round counts only if the
    profile holds every kernel function of `want` ({name: launches}) as
    often as fn launches it: a profile can lose a kernel's device events,
    and then its class would read low. Raises if no round of `rounds`
    does."""
    seen = []
    for attempt in range(1, rounds + 1):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        split = {"loss_CD": 0.0, "bn_passes": 0.0, "entry": 0.0, "head": 0.0,
                 "resample_dw": 0.0, "convs": 0.0, "bn": 0.0, "other": 0.0}
        other, counts = [], dict.fromkeys(want, 0)
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            part = classify(e.key)
            split[part] += e.device_time_total / 1e3
            if part == "other":
                other.append((e.key[:60], round(e.device_time_total / 1e3, 3),
                              e.count))
            for name in want:
                if re.search(rf"(?<!\w){name}(?!\w)", e.key):
                    counts[name] += e.count
        if counts == want:
            return split, sorted(other, key=lambda o: -o[1])[:8], attempt
        seen.append({k: v for k, v in counts.items() if v != want[k]})
    raise SystemExit(f"device_split: no complete profile in {rounds} rounds; "
                     f"kernel launches seen against {want}: {seen}")


def pass_geometries(n=TRAIN_BATCH):
    """The passes of the train-mode stem and IR chain on the config-#2 path
    (513², batch n): 17 forward (label, kind, input NHWC shape, Co, relu,
    input BN?) in order, and their 17 backward links in reverse order
    (label, kind, a_k shape, Co, relu_k, input BN?, next-BN backward?)."""
    from kd_cheap_conv_tpu_torch.ops.irchain import _BLOCKS

    h = (CROP - 1) // 2 + 1
    fwd = [("f1.dw", "bn_dw", (n, h, h, 32), 32, True, True),
           ("f1.pw", "bn_pw", (n, h, h, 32), 16, True, True),
           ("f2.pwE", "bn_pw", (n, h, h, 16), 96, False, True),
           ("f2.dw", "bn_dw_s2", (n, h, h, 96), 96, True, True)]
    h = (h + 1) // 2
    fwd.append(("f2.pwP", "bn_pw", (n, h, h, 96), 24, True, True))
    for i, (stride, cin, ce, cout, _) in enumerate(_BLOCKS):
        f = f"f{3 + i}"
        fwd.append((f + ".pwE", "bn_pw", (n, h, h, cin), ce, False, False))
        fwd.append((f + ".dw", "bn_dw" if stride == 1 else "bn_dw_s2",
                    (n, h, h, ce), ce, True, True))
        h = (h - 1) // stride + 1
        fwd.append((f + ".pwP", "bn_pw", (n, h, h, ce), cout, True, True))
    back = {"bn_pw": "pw_bwd", "bn_dw": "dw_bwd", "bn_dw_s2": "dw_s2_bwd"}
    bwd = [(lbl, back[k], shape, co, relu, has_bn, not lbl.endswith("pwP"))
           for lbl, k, shape, co, relu, has_bn in reversed(fwd)]
    return fwd, bwd


def pass_out_shape(kind, shape, co):
    n, h, w, _ = shape
    s = 2 if kind in ("bn_dw_s2", "dw_s2_bwd") else 1
    return (n, (h - 1) // s + 1, (w - 1) // s + 1, co)


def pass_args(geo, dtype, g):
    """Seeded inputs of one pass at its geometry: activations ~N(0, 1) in
    `dtype`, f32 BN packs with plausible moments, weights scaled by fan-in;
    the wrapper's positional arguments."""
    from kd_cheap_conv_tpu_torch.ops import stem as tst

    kind, shape, co, relu, has_bn = geo[1:6]
    ci = shape[-1]

    def randn(*s, scale=1.0):
        return scale * torch.randn(s, device="cuda", generator=g)

    def bn_pack(c):
        return torch.stack([randn(c, scale=0.1),
                            0.5 + torch.rand(c, device="cuda", generator=g),
                            1 + randn(c, scale=0.2), randn(c, scale=0.1)], 1)

    bn = bn_pack(ci) if has_bn else None
    if kind in ("bn_pw", "pw_bwd"):
        wk = randn(co, ci, scale=ci ** -0.5).to(dtype)
    else:
        wk = randn(ci, 9, scale=1 / 3)
    x = randn(*shape).to(dtype)
    if kind.startswith("bn_"):
        return (x, bn, wk, relu, tst.EPS)
    out = pass_out_shape(kind, shape, co)
    m = out[0] * out[1] * out[2]
    pn = None
    if geo[6]:
        pn = torch.stack([randn(co, scale=0.1),
                          0.5 + torch.rand(co, device="cuda", generator=g),
                          1 + randn(co, scale=0.2), randn(co, scale=m ** 0.5),
                          randn(co, scale=m ** 0.5),
                          torch.full((co,), 1.0 / m, device="cuda")], 1)
    return (randn(*out).to(dtype), randn(*out).to(dtype), x, pn, bn, wk,
            relu, tst.EPS)


def pass_fns(kind):
    """(kernel wrapper, plain version with the wrapper's outputs)."""
    from kd_cheap_conv_tpu_torch.ops import stem as tst

    stride = {"bn_dw": 1, "bn_dw_s2": 2, "dw_bwd": 1, "dw_s2_bwd": 2}
    if kind.startswith("bn_"):
        ref = tst.bn_pw_ref if kind == "bn_pw" else functools.partial(
            tst.bn_dw_ref, stride=stride[kind])

        def plain(*args):
            y, sums = ref(*args)
            return (y, *tst._moments(sums, tst._count(y)))
    else:
        plain = tst.pw_bwd_ref if kind == "pw_bwd" else functools.partial(
            tst.dw_bwd_ref, stride=stride[kind])
    return getattr(tst, f"run_{kind}"), plain


def pass_bound_ms(geo, esize=2):
    """Least time of one pass on the card, as (bytes ms, FLOP ms): each
    activation read or written once in the activation dtype, weights and
    BN packs once, the CTA partials not counted; FLOPs of its conv (and,
    backward, of its weight gradient) over the bf16 tensor-core peak."""
    kind, shape, co = geo[1:4]
    n, h, w, ci = shape
    out = pass_out_shape(kind, shape, co)
    p_in, p_out = n * h * w, out[0] * out[1] * out[2]
    if kind == "bn_pw":
        acts, flops, wts = p_in * (ci + co), 2 * p_in * ci * co, co * ci * esize
    elif kind.startswith("bn_dw"):
        acts, flops, wts = p_in * ci + p_out * co, 18 * p_out * ci, 36 * ci
    elif kind == "pw_bwd":
        acts = p_in * (co * (2 if geo[6] else 1) + 2 * ci)
        flops, wts = 4 * p_in * ci * co, co * ci * esize
    else:
        acts, flops, wts = 2 * (p_out + p_in) * ci, 36 * p_out * ci, 36 * ci
    nbytes = acts * esize + wts + 16 * (ci + co)
    return nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3


def rel_err(got, want):
    """max |got - want| / max |want| (float32), and the max abs error."""
    got, want = got.detach().float(), want.detach().float()
    d = float((got - want).abs().max())
    return d / max(float(want.abs().max()), 1e-30), d


def chain_parity(g, worst):
    """Phase chain_parity, kernel by kernel: every geometry, f32 and bf16."""
    fwd, bwd = pass_geometries()
    for dtype in (torch.float32, torch.bfloat16):
        for geo in fwd + bwd:
            kind = geo[1]
            kernel, plain = pass_fns(kind)
            args = pass_args(geo, dtype, g)
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(got, want)]
            ok = all(r <= PASS_TOL[dtype] for r, _ in errs)
            worst[kind, dtype] = max(worst.get((kind, dtype), 0.0),
                                     errs[0][1])
            phase("chain_parity", kernel=kind, at=geo[0],
                  shape=list(geo[2]), co=geo[3], dtype=str(dtype)[6:],
                  rel_errs=[r for r, _ in errs],
                  max_abs_errs=[d for _, d in errs], tol=PASS_TOL[dtype],
                  ok=ok)
            if not ok:
                raise SystemExit(f"chain parity failed: {kind} at {geo[0]} "
                                 f"{dtype}")
            del got, want, args


def features_parity(seed=3):
    """Phase entry_parity, whole chains: features[0..6] of the student at
    batch 16, 513², from the image, one train-mode step from fresh running
    statistics with momentum None (so the running statistics are the batch
    statistics), through the chains with the entry-conv kernels (f32) and
    through `_forward_modules` in f32 and f64. Both f32 paths are held to
    the f64 one; the chains' gradients must stay within 3x the module
    path's own f32 error. Then the chains' backward twice on the same
    inputs, the image's gradient included, bit for bit, in f32 and bf16."""
    from kd_cheap_conv_tpu_torch.ops import stem as tst
    from kd_cheap_conv_tpu_torch.ops.irchain import fused_ir_chain

    bb = student(torch.float32, seed=seed).backbone
    for m in bb.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None
    bb.train()
    ref = copy.deepcopy(bb)
    r64 = copy.deepcopy(bb).double()
    for m in r64.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = None
    if not (bb._fused_stem_active() and bb._fused_ir_active()):
        raise SystemExit("chain_parity: the student's guards refuse the "
                         "chains")
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((TRAIN_BATCH, 3, CROP, CROP), device="cuda",
                    generator=g).contiguous(memory_format=torch.channels_last)
    for fn in tst.PASSES + tst.F0_KERNELS:
        fn.launches = 0
    out, low = bb._call_fused_stem_ir(x)
    want = ref._forward_modules(x, stop=7)
    w64 = r64._forward_modules(x.double(), stop=7)
    wo, wl = (torch.randn(t.shape, device="cuda", generator=g)
              for t in (out, low))
    for o, lw in ((out, low), (want["out"], want["low_level"]),
                  (w64["out"], w64["low_level"])):
        ((o * wo.to(o.dtype)).sum() + (lw * wl.to(lw.dtype)).sum()).backward()
    torch.cuda.synchronize()
    launches = {fn.__name__[4:]: fn.launches
                for fn in tst.PASSES + tst.F0_KERNELS}
    if launches != {**{k: v[1] for k, v in PASSES.items()},
                    **{k: v[1] for k, v in ENTRY.items() if k != "tstem"}}:
        raise SystemExit(f"entry_parity: features[0..6] ran {launches}")

    def l2(a, b):
        return float((a.detach().double() - b.detach()).norm())

    res = {"values": max(l2(a, c) / float(c.norm())
                         for a, c in ((out, w64["out"]),
                                      (low, w64["low_level"]))),
           "values_modules": max(l2(b, c) / float(c.norm())
                                 for b, c in ((want["out"], w64["out"]),
                                              (want["low_level"],
                                               w64["low_level"])))}
    trip = [(k, p.grad, q.grad, r.grad) for (k, p), q, r in zip(
        bb.named_parameters(), ref.parameters(), r64.parameters())
        if int(k.split(".")[1]) <= 6]
    # a floor for f1.pw_bn's bias, whose exact gradient is zero (its shift
    # meets a linear conv and a train-mode BN)
    floor = 1e-7 * max(float(c.norm()) for *_, c in trip)
    ratios = sorted(((l2(a, c) / (l2(b, c) + floor), k)
                     for k, a, b, c in trip), reverse=True)
    res["grads_vs_modules_noise"], res["grads_worst"] = (ratios[0][0],
                                                         ratios[:3])
    big = 1e4 * floor
    res["grads_rel_l2_max"] = [max(l2(t[i], t[3]) / max(float(t[3].norm()),
                                                       big) for t in trip)
                               for i in (1, 2)]           # chains, modules
    mods = dict(r64.named_modules())
    stats = [rel_err(getattr(m, a).double(), getattr(mods[k], a))[0]
             for k, m in bb.named_modules()
             if isinstance(m, torch.nn.BatchNorm2d)
             and int(k.split(".")[1]) <= 6
             for a in ("running_mean", "running_var")]
    res["stats"] = max(stats)
    ok = (len(stats) == 36 and res["values"] <= FEAT_TOL["values"]
          and res["stats"] <= FEAT_TOL["stats"]
          and res["grads_vs_modules_noise"] <= FEAT_TOL["grads_vs_noise"])
    del ref, r64, want, w64

    # the chains' own backward, twice, down to the image
    def chain_grads(img, sp, ip, wo, wl):
        z, _ = tst.fused_stem_f1f2(img, sp)
        o, lw, _ = fused_ir_chain(z, ip)
        loss = ((o.permute(0, 3, 1, 2).float() * wo).sum()
                + (lw.permute(0, 3, 1, 2).float() * wl).sum())
        return torch.autograd.grad(loss, [img, *sp.values(), *ip.values()])

    same = {}
    img, sp, _ = bb._stem_inputs(x)
    ip = bb._ir_params()[0]
    for dtype in (torch.float32, torch.bfloat16):
        a = img.detach().to(dtype).requires_grad_()
        first = chain_grads(a, sp, ip, wo, wl)
        second = chain_grads(a, sp, ip, wo, wl)
        same[str(dtype)[6:]] = all(torch.equal(u, v)
                                   for u, v in zip(first, second))
    torch.cuda.synchronize()
    phase("entry_parity", what="features[0..6] from the image, chains with "
          "the entry-conv kernels (f32) and _forward_modules (f32) against "
          "_forward_modules in f64, batch 16, 513²", launches=launches,
          **res, tol=FEAT_TOL, backward_twice_bit_identical=same,
          ok=ok and all(same.values()))
    if not (ok and all(same.values())):
        raise SystemExit("entry_parity: features[0..6] disagree with the "
                         "module path, or the backward is not deterministic")


def teacher_stem(seed=5):
    """A ResNet stem (conv 7x7 / stride 2 / pad 3, BN, relu; bf16 compute)
    in eval mode on the card, with seeded random BN statistics."""
    from kd_cheap_conv_tpu_torch.models.layers import ConvBNReLU

    g = torch.Generator().manual_seed(seed)
    stem = ConvBNReLU(3, 64, 7, stride=2, padding=3, dtype=torch.bfloat16,
                      generator=g)
    bn = stem.bn
    bn.weight.data = 1 + 0.2 * torch.randn(64, generator=g)
    bn.bias.data = 0.2 * torch.randn(64, generator=g)
    bn.running_mean = 0.3 * torch.randn(64, generator=g)
    bn.running_var = 1 + 0.5 * torch.rand(64, generator=g)
    return stem.to("cuda").eval()


def entry_args(dtype, g, n=TRAIN_BATCH, h=CROP, w=CROP):
    """Seeded inputs of the entry-conv kernels at an (n, h, w) image: the
    image, gy0 and a0 ~N(0, 1) in `dtype`, w0 (32, 3, 3, 3) f32 scaled by
    fan-in, bn0's backward pack with plausible moments and sums."""
    ho, wo = (h + 1) // 2, (w + 1) // 2
    m = n * ho * wo

    def randn(*s, scale=1.0):
        return scale * torch.randn(s, device="cuda", generator=g)

    x = randn(n, h, w, 3).to(dtype)
    w0 = randn(32, 3, 3, 3, scale=27 ** -0.5)
    gy, a0 = (randn(n, ho, wo, 32).to(dtype) for _ in range(2))
    pn = torch.stack([randn(32, scale=0.1),
                      0.5 + torch.rand(32, device="cuda", generator=g),
                      1 + randn(32, scale=0.2), randn(32, scale=m ** 0.5),
                      randn(32, scale=m ** 0.5),
                      torch.full((32,), 1.0 / m, device="cuda")], 1)
    return x, w0, gy, a0, pn


def entry_fns(k, x, w0, gy, a0, pn, stem):
    """(kernel wrapper call, plain version call) of entry kernel k on these
    inputs, each returning a tuple of outputs (call under no_grad)."""
    from kd_cheap_conv_tpu_torch.ops import stem as tst
    from kd_cheap_conv_tpu_torch.ops import tstem as tts

    if k == "f0":
        def plain():
            y, sums = tst.f0_ref(x, w0)
            return (y, *tst._moments(sums, tst._count(y)))
        return (lambda: tst.run_f0(x, w0)), plain
    if k == "f0_wgrad":
        return ((lambda: (tst.run_f0_wgrad(gy, a0, x, pn),)),
                lambda: (tst.f0_wgrad_ref(gy, a0, x, pn),))
    if k == "f0_xgrad":
        return ((lambda: (tst.run_f0_xgrad(gy, a0, pn, w0, x.shape),)),
                lambda: (tst.f0_xgrad_ref(gy, a0, pn, w0, x.shape),))
    return ((lambda: (tts.fused_stem_pool_eval(x, stem.conv, stem.bn),)),
            lambda: (tts.fused_stem_pool_eval_ref(x, stem.conv, stem.bn),))


def entry_stock(k, x, w0, gy, a0, pn, stem):
    """The stock sequence entry kernel k replaces, on its inputs: the cuDNN
    entry conv and bn0's two moment reductions (as the a0-mode chain takes them);
    bn0's backward affine and the cuDNN weight- or input-gradient conv; the
    cuDNN 7x7 conv, eval BN, relu and max_pool2d."""
    import torch.nn.functional as F

    from kd_cheap_conv_tpu_torch.ops import stem as tst

    xc, wc = x.permute(0, 3, 1, 2), w0.to(x.dtype)   # NCHW, channels_last
    if k == "tstem":
        return lambda: F.max_pool2d(stem(xc), 3, 2, 1)
    if k == "f0":
        def run():
            a = F.conv2d(xc, wc, None, 2, 1).permute(0, 2, 3, 1).contiguous()
            cnt = float(tst._count(a))
            m = a.sum((0, 1, 2), dtype=torch.float32) / cnt
            v = (torch.linalg.vector_norm(a, 2, (0, 1, 2),
                                          dtype=torch.float32).square()
                 / cnt - m * m)
            return a, m, v
        return run

    def ga():
        return tst._bn_bwd_affine(
            gy, a0 - pn[:, 0], torch.rsqrt(pn[:, 1] + tst.EPS), pn[:, 2],
            pn[:, 3], pn[:, 4], float(tst._count(gy))).to(x.dtype).permute(
                0, 3, 1, 2)
    if k == "f0_wgrad":
        return lambda: torch.nn.grad.conv2d_weight(xc, wc.shape, ga(), 2, 1)
    return lambda: torch.nn.grad.conv2d_input(xc.shape, wc, ga(), 2, 1)


def entry_bound_ms(k, n=TRAIN_BATCH, h=CROP, w=CROP, c0=32, esize=2):
    """Least time of entry kernel k on the card, as (bytes ms, FLOP ms):
    the image, a0 / gy0 and the output each moved once in the activation
    dtype, the weights once; the conv's multiply-adds (two FLOPs each) over
    the bf16 tensor-core peak."""
    ho, wo = (h + 1) // 2, (w + 1) // 2
    img, act = n * h * w * 3 * esize, n * ho * wo * c0 * esize
    if k == "tstem":
        po, qo = (ho + 1) // 2, (wo + 1) // 2
        nbytes = img + n * po * qo * 64 * esize + 64 * 147 * esize
        flops = 2 * n * ho * wo * 64 * 147
    else:
        nbytes = (img + act if k == "f0" else img + 2 * act) + c0 * 27 * esize
        flops = 2 * n * ho * wo * c0 * 27
    return nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3


def entry_parity(g, worst):
    """Phase entry_parity, kernel by kernel: the four entry kernels at
    config #2's shapes, f32 and bf16, against their plain versions (the f0
    kernels to PASS_TOL relative to the largest value, the stem to TOL per
    element); the weight gradient twice, bit for bit; the image gradient
    again at an odd-by-even size."""
    stem = teacher_stem()
    cases = [(k, TRAIN_BATCH, CROP, CROP) for k in ENTRY]
    cases.append(("f0_xgrad", 2, 18, 17))
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for k, n, h, w in cases:
                args = entry_args(dtype, g, n, h, w)
                kernel, plain = entry_fns(k, *args, stem)
                got, want = kernel(), plain()
                second = kernel() if k == "f0_wgrad" else got
                torch.cuda.synchronize()
                errs = [rel_err(a, b) for a, b in zip(got, want)]
                if k == "tstem":
                    rtol, atol = TOL[dtype]
                    a, b = got[0].float(), want[0].float()
                    ok = bool(((a - b).abs() <= atol + rtol * b.abs()).all())
                    tol = [rtol, atol]
                else:
                    ok = all(r <= PASS_TOL[dtype] for r, _ in errs)
                    tol = PASS_TOL[dtype]
                twice = all(torch.equal(a, b) for a, b in zip(got, second))
                worst[k, dtype] = max(worst.get((k, dtype), 0.0),
                                      *(d for _, d in errs))
                phase("entry_parity", kernel=k, image=[n, h, w, 3],
                      dtype=str(dtype)[6:], rel_errs=[r for r, _ in errs],
                      max_abs_errs=[d for _, d in errs], tol=tol,
                      twice_bit_identical=twice if k == "f0_wgrad" else None,
                      ok=ok and twice)
                if not (ok and twice):
                    raise SystemExit(f"entry parity failed: {k} at "
                                     f"{[n, h, w]} {dtype}")
                del args, got, want, second


def entry_times(g, total, bound, stock, card):
    """Phase entry_time: each entry kernel at config #2's shapes in bf16,
    the device time of its wrapper (the kernel, the weight casts and the
    partial-sum reduction), of its plain version and of the stock sequence
    it replaces (torch.profiler), and its bound."""
    stem = teacher_stem()
    args = entry_args(torch.bfloat16, g)
    with torch.no_grad():
        for k in ENTRY:
            kernel, plain = entry_fns(k, *args, stem)
            t_ker, t_ref = device_ms_all(kernel), device_ms_all(plain)
            t_stock = device_ms_all(entry_stock(k, *args, stem))
            b_bytes, b_ops = entry_bound_ms(k)
            total[k, torch.bfloat16] = (t_ker, t_ref)
            bound[k] = [max(b_bytes, b_ops), b_bytes, b_ops]
            stock[k] = t_stock
            phase("entry_time", kernel=k, image=list(args[0].shape),
                  dtype="bfloat16", ms=round(t_ker, 4),
                  plain_ms=round(t_ref, 4), stock_ms=round(t_stock, 4),
                  bound_ms=round(max(b_bytes, b_ops), 5),
                  bound_by="bytes" if b_bytes >= b_ops else "operations",
                  card=card)
    del args


def pass_times(g, total, bound):
    """Phase pass_time: each pass kernel at each of its geometries against
    its plain version, bf16 (device time of all the wrapper launches: the
    kernel and its partial-sum reduction). Accumulates per-step sums."""
    fwd, bwd = pass_geometries()
    for geo in fwd + bwd:
        kind = geo[1]
        kernel, plain = pass_fns(kind)
        args = pass_args(geo, torch.bfloat16, g)
        t_ker = device_ms_all(lambda: kernel(*args))
        t_ref = device_ms_all(lambda: plain(*args))
        b_bytes, b_ops = pass_bound_ms(geo)
        tk, tr = total.get((kind, torch.bfloat16), (0.0, 0.0))
        total[kind, torch.bfloat16] = (tk + t_ker, tr + t_ref)
        acc = bound.setdefault(kind, [0.0, 0.0, 0.0])
        acc[0] += max(b_bytes, b_ops)
        acc[1] += b_bytes
        acc[2] += b_ops
        phase("pass_time", kernel=kind, at=geo[0], shape=list(geo[2]),
              co=geo[3], dtype="bfloat16", ms=round(t_ker, 4),
              plain_ms=round(t_ref, 4),
              bound_ms=round(max(b_bytes, b_ops), 5),
              bound_by="bytes" if b_bytes >= b_ops else "operations")
        del args


def features_times(card):
    """Phase features_time: features[0..6] from the image in bf16 at batch
    16, 513², train mode, forward and forward + backward, timed in turns
    with CUDA events: the chains with the entry-conv kernels against the
    cuDNN entry conv feeding the chains its output (the a0 mode), and
    against the module path."""
    from kd_cheap_conv_tpu_torch.ops.irchain import fused_ir_chain
    from kd_cheap_conv_tpu_torch.ops.stem import fused_stem_f1f2

    bb = student(torch.bfloat16, seed=4).backbone.train()
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((TRAIN_BATCH, 3, CROP, CROP), device="cuda",
                    generator=g).contiguous(memory_format=torch.channels_last)
    eps = float(bb.features[0].bn.eps)
    _, sp, _ = bb._stem_inputs(x[:1])              # views of the weights
    sp_a0 = {k: v for k, v in sp.items() if k != "w0"}
    ip = bb._ir_params()[0]

    def finish(out, low, backward):
        if backward:
            (out.float().sum() + low.float().sum()).backward()

    def f0_chain(backward):
        img, p, _ = bb._stem_inputs(x)
        z, _ = fused_stem_f1f2(img, p, eps)
        finish(*fused_ir_chain(z, ip, eps)[:2], backward)

    def a0_chain(backward):
        a0 = bb.features[0].conv(x).permute(0, 2, 3, 1).contiguous()
        z, _ = fused_stem_f1f2(a0, sp_a0, eps)
        finish(*fused_ir_chain(z, ip, eps)[:2], backward)

    def modules(backward):
        res = bb._forward_modules(x, stop=7)
        finish(res["out"], res["low_level"], backward)

    rows = {}
    for what, bwd in (("forward", False), ("forward_backward", True)):
        t_f0, t_a0 = paired_ms(lambda: f0_chain(bwd), lambda: a0_chain(bwd),
                               reps=3)
        t_f0m, t_mod = paired_ms(lambda: f0_chain(bwd),
                                 lambda: modules(bwd), reps=3)
        rows[what] = {"f0_chain_ms": round(t_f0, 3),
                      "a0_chain_ms": round(t_a0, 3),
                      "f0_chain_vs_modules_ms": round(t_f0m, 3),
                      "modules_ms": round(t_mod, 3)}
    phase("features_time", what="features[0..6] from the image, train mode, "
          "batch 16, 513², bf16; f0 chain vs cuDNN entry conv + a0-mode "
          "chain, and vs modules, each pair in turns", **rows, card=card)


def head_inputs(dtype, g, n=TRAIN_BATCH):
    """Seeded inputs of the head kernels at config #2's shapes: low (n,
    129, 129, 48), up (.., 256) and the ASPP input (n, 33, 33, 320) ~N(0, 1)
    in `dtype`; the separable conv's arguments by dilation ("sep": 6, 12
    and 18 the ASPP branches, 1 the serving decoder's fuse conv, (BATCH,
    129, 129, 304) -> 256); a and its batch moments from the plain P1; weights
    scaled by fan-in (1x1 weights in `dtype`, depthwise taps f32); BN packs
    with those moments and plausible affine parameters and sums; the
    cotangents g (logits) and gu ~N(0, 1)."""
    from kd_cheap_conv_tpu_torch.ops import decoder as tdec
    from kd_cheap_conv_tpu_torch.ops import stem as tst

    def randn(*s, scale=1.0):
        return scale * torch.randn(s, device="cuda", generator=g)

    ci = CL + CU
    d = {"low": randn(n, HEAD, HEAD, CL).to(dtype),
         "up": randn(n, HEAD, HEAD, CU).to(dtype),
         "k": randn(ci, 9, scale=1 / 3),
         "pw": randn(CM, ci, scale=ci ** -0.5).to(dtype),
         "wc": randn(N_CLS, CM, scale=CM ** -0.5).to(dtype),
         "bc": randn(N_CLS, scale=0.1),
         "sep": {}}
    x, pws = (randn(n, ASPP_HW, ASPP_HW, ASPP_C).to(dtype),
              randn(CM, ASPP_C, 1, 1, scale=ASPP_C ** -0.5).to(dtype))
    for dil in ASPP_DIL:
        d["sep"][dil] = (x, randn(ASPP_C, 1, 3, 3, scale=1 / 3).to(dtype),
                         pws, dil)
    d["sep"][1] = (randn(BATCH, HEAD, HEAD, ci).to(dtype),
                   randn(ci, 1, 3, 3, scale=1 / 3).to(dtype),
                   randn(CM, ci, 1, 1, scale=ci ** -0.5).to(dtype), 1)
    with torch.no_grad():
        a, sums = tdec.sep_fwd_ref(d["low"], d["up"], d["k"], d["pw"])
    mean, var = tst._moments(sums, tst._count(a))
    m = tst._count(a)
    gam = 1 + randn(CM, scale=0.2)
    d.update(a=a, bn=tst._bn_pack(mean, var, gam, randn(CM, scale=0.1)),
             pn=torch.stack([mean, var, gam, randn(CM, scale=m ** 0.5),
                             randn(CM, scale=m ** 0.5),
                             torch.full((CM,), 1.0 / m, device="cuda")], 1),
             gl=randn(n, HEAD, HEAD, N_CLS).to(dtype),
             gu=randn(n, HEAD, HEAD, CM).to(dtype))
    return d


def head_fns(k, d, dil=None):
    """(kernel wrapper call, plain version call, kinds of the outputs) of
    head kernel k on inputs d; kinds: 'values', 'weights' (held to
    PASS_TOL, 'weights' also twice bit for bit) or 'sums' (HEAD_SUM_TOL)."""
    from kd_cheap_conv_tpu_torch.ops import decoder as tdec
    from kd_cheap_conv_tpu_torch.ops import separable as tsep
    from kd_cheap_conv_tpu_torch.ops import stem as tst

    if k == "sep":
        args = d["sep"][dil]
        return ((lambda: (tsep.run_separable(*args),)),
                (lambda: (tsep.separable_ref(*args),)), ("values",))
    if k == "sep_fwd":
        args = (d["low"], d["up"], d["k"], d["pw"])

        def plain():
            a, sums = tdec.sep_fwd_ref(*args)
            return (a, *tst._moments(sums, tst._count(a)))
        return ((lambda: tdec.run_sep_fwd(*args)), plain,
                ("values", "sums", "sums"))
    if k == "head_fwd":
        args = (d["a"], d["bn"], d["wc"], d["bc"])
        return ((lambda: (tdec.run_head_fwd(*args),)),
                (lambda: (tdec.head_fwd_ref(*args),)), ("values",))
    if k == "head_bwd":
        args = (d["gl"], d["a"], d["bn"], d["wc"])
        return ((lambda: tdec.run_head_bwd(*args)),
                (lambda: tdec.head_bwd_ref(*args)),
                ("values", "sums", "weights", "weights"))
    args = (d["gu"], d["a"], d["low"], d["up"], d["pn"], d["k"], d["pw"])
    return ((lambda: tdec.run_sep_bwd(*args)),
            (lambda: tdec.sep_bwd_ref(*args)),
            ("values", "values", "weights", "weights"))


def head_stock(k, d, dil=None):
    """The stock sequence head kernel k replaces, on its inputs (NCHW views
    in channels_last memory): a branch's cuDNN depthwise + 1x1 conv; the
    concat, cuDNN depthwise + 1x1 conv and the BN's batch moments (P1); the
    BN with those moments, relu and the classifier conv (P2); autograd's
    relu and classifier backward and the BN-backward sums (B1); the BN's
    train backward and autograd's 1x1 and depthwise backward (B2)."""
    import torch.nn.functional as F

    from kd_cheap_conv_tpu_torch.ops import stem as tst

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    ci = CL + CU
    kk, pw4 = d["k"].to(d["pw"].dtype).reshape(ci, 1, 3, 3), d["pw"][..., None, None]
    if k == "sep":
        x, dw, pws, _ = d["sep"][dil]
        return lambda: F.conv2d(F.conv2d(nchw(x), dw, None, 1, dil, dil,
                                         x.shape[-1]), pws)
    if k == "sep_fwd":
        def run():
            x = torch.cat([nchw(d["low"]), nchw(d["up"])], 1)
            a = F.conv2d(F.conv2d(x, kk, None, 1, 1, 1, ci), pw4)
            return a, torch.var_mean(a, (0, 2, 3), correction=0)
        return run
    a, bn = nchw(d["a"]), d["bn"]
    if k == "head_fwd":
        return lambda: F.conv2d(torch.relu(F.batch_norm(
            a, bn[:, 0], bn[:, 1], bn[:, 2], bn[:, 3], False, 0.0, tst.EPS)),
            d["wc"][..., None, None], d["bc"].to(a.dtype))
    if k == "head_bwd":
        u = F.batch_norm(a, bn[:, 0], bn[:, 1], bn[:, 2], bn[:, 3], False,
                         0.0, tst.EPS).detach().requires_grad_()
        wc = d["wc"][..., None, None].detach().requires_grad_()
        bc = d["bc"].to(a.dtype).detach().requires_grad_()
        y = F.conv2d(torch.relu(u), wc, bc)
        xh = (a - bn[:, 0, None, None]) * torch.rsqrt(bn[:, 1, None, None]
                                                      + tst.EPS)

        def run():
            gu, gw, gb = torch.autograd.grad(y, (u, wc, bc), nchw(d["gl"]),
                                             retain_graph=True)
            return gu, gu.sum((0, 2, 3)), (gu * xh).sum((0, 2, 3)), gw, gb
        return run
    low, up = (nchw(d[t]).detach().requires_grad_() for t in ("low", "up"))
    kw = kk.detach().requires_grad_()
    pw = pw4.detach().requires_grad_()
    a2 = F.conv2d(F.conv2d(torch.cat([low, up], 1), kw, None, 1, 1, 1, ci), pw)
    pn = d["pn"]

    def run():
        ga = tst._bn_bwd_affine(
            d["gu"], d["a"] - pn[:, 0], torch.rsqrt(pn[:, 1] + tst.EPS),
            pn[:, 2], pn[:, 3], pn[:, 4], float(tst._count(d["a"]))).to(
                a2.dtype)
        return torch.autograd.grad(a2, (low, up, kw, pw), nchw(ga),
                                   retain_graph=True)
    return run


def head_bound_ms(k, n=TRAIN_BATCH, esize=2):
    """Least time of head kernel k on the card, as (bytes ms, FLOP ms):
    each activation read or written once in bf16, the weights once; the
    FLOPs of its products and depthwise taps over the bf16 tensor-core
    peak. "sep" is one ASPP branch."""
    ci = CL + CU
    p = n * HEAD * HEAD
    wts = (CM * ci + N_CLS * CM) * esize + ci * 9 * 4
    if k == "sep":
        q = n * ASPP_HW * ASPP_HW
        nbytes = q * (ASPP_C + CM) * esize + ASPP_C * (CM * esize + 36)
        flops = 2 * q * ASPP_C * (9 + CM)
    elif k == "sep_fwd":
        nbytes = p * (ci + CM) * esize + wts
        flops = 2 * p * ci * (9 + CM)
    elif k == "head_fwd":
        nbytes = p * (CM + N_CLS) * esize + wts
        flops = 2 * p * CM * N_CLS
    elif k == "head_bwd":
        nbytes = p * (N_CLS + 2 * CM) * esize + wts
        flops = 4 * p * CM * N_CLS
    else:
        nbytes = p * (2 * CM + 2 * ci) * esize + wts
        flops = 4 * p * ci * CM + 3 * 18 * p * ci
    return nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3


def head_parity(g, worst):
    """Phase head_parity, kernel by kernel: the five head kernels at config
    #2's shapes, f32 and bf16, against their plain versions (the separable
    conv on the three ASPP branches and at the serving decoder's fuse conv,
    dilation 1); the weight gradients (dWc, dbc, dpw, dk) of a second run
    bit for bit."""
    for dtype in (torch.float32, torch.bfloat16):
        d = head_inputs(dtype, g)
        for k in HEAD_KERNELS:
            for dil in ((*ASPP_DIL, 1) if k == "sep" else (None,)):
                kernel, plain, kinds = head_fns(k, d, dil)
                with torch.no_grad():
                    got, want = kernel(), plain()
                    second = kernel()
                torch.cuda.synchronize()
                errs = [rel_err(a, b) for a, b in zip(got, want)]
                tols = [HEAD_SUM_TOL if kd == "sums" else PASS_TOL[dtype]
                        for kd in kinds]
                if k == "sep" and dtype == torch.bfloat16:
                    tols = [ulp_rel(want[0])]
                ok = all(r <= t for (r, _), t in zip(errs, tols))
                twice = all(torch.equal(a, b) for a, b, kd in
                            zip(got, second, kinds) if kd == "weights")
                worst[k, dtype] = max(worst.get((k, dtype), 0.0),
                                      *(e for _, e in errs))
                phase("head_parity", kernel=k, dilation=dil,
                      shape=list(got[0].shape),
                      dtype=str(dtype)[6:], outputs=list(kinds),
                      rel_errs=[r for r, _ in errs],
                      max_abs_errs=[e for _, e in errs], tol=tols,
                      weights_twice_bit_identical=twice, ok=ok and twice)
                if not (ok and twice):
                    raise SystemExit(f"head parity failed: {k} {dil} {dtype}")
                del got, want, second
        del d


def head_module(dtype=None, seed=8):
    """config #2's DeepLabV3+ head (320 -> 256 ASPP, 24 -> 48 low level, 21
    classes), separable-converted, seeded random BN affine parameters,
    fresh running statistics with momentum None (so they become the batch
    statistics), dropout off, train mode, on the card."""
    from kd_cheap_conv_tpu_torch.kd.replace import replace_cheap_convs
    from kd_cheap_conv_tpu_torch.models.deeplab import DeepLabHeadV3Plus

    gen = torch.Generator().manual_seed(seed)
    head = DeepLabHeadV3Plus(ASPP_C, 24, N_CLS, dtype=dtype, generator=gen)
    replace_cheap_convs(head, generator=gen)
    head.aspp.dropout.p = 0.0
    for m in head.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            m.weight.data = 1 + 0.2 * torch.randn(c, generator=gen)
            m.bias.data = 0.1 * torch.randn(c, generator=gen)
            m.reset_running_stats()
            m.momentum = None
    return head.to("cuda", memory_format=torch.channels_last).train()


def stock_model(model):
    """model with the separable, depthwise and upsample kernels turned off
    on its modules (instance attributes): every separable conv runs its two
    convs, every depthwise conv and the decoder's upsample run cuDNN and
    F.interpolate."""
    from kd_cheap_conv_tpu_torch.kd.replace import AtrousSeparableConvolution
    from kd_cheap_conv_tpu_torch.models.deeplab import DeepLabHeadV3Plus
    from kd_cheap_conv_tpu_torch.models.layers import Conv2d

    for m in model.modules():
        if isinstance(m, AtrousSeparableConvolution):
            m.fused_active = lambda: False
        elif isinstance(m, Conv2d):
            m.depthwise_active = lambda dtype: False
        elif isinstance(m, DeepLabHeadV3Plus):
            m.upsample_active = lambda x, size: False
    return model


def stock_head(head):
    """The same head on the module path with stock convs and upsample: the
    fused head and the separable, depthwise and upsample kernels turned off
    on this instance."""
    head._fused_head_active = lambda return_features: False
    return stock_model(head)


def head_features(dtype, seed, n=TRAIN_BATCH):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {"low_level": torch.randn((n, 24, HEAD, HEAD), device="cuda",
                                     generator=g).to(dtype),
            "out": torch.randn((n, ASPP_C, ASPP_HW, ASPP_HW), device="cuda",
                               generator=g).to(dtype)}


def head_module_parity(seed=8):
    """Phase head_parity, the whole head: forward and backward at batch 16
    in f32 through the kernels (three separable launches, the four passes,
    the upsample and its gradient, and the ASPP branches' depthwise conv,
    dx and dk), through `_forward_modules` with stock convs and upsample in
    f32 and in f64 (TF32 off for cuDNN and matmuls). Both f32 paths are held to
    the f64 one: values 1e-5, running statistics 1e-4, and the kernels'
    gradients (the head's parameters and both inputs) within 3x the module
    path's own f32 error."""
    from kd_cheap_conv_tpu_torch.ops import decoder as tdec
    from kd_cheap_conv_tpu_torch.ops import dwconv as tdw
    from kd_cheap_conv_tpu_torch.ops import separable as tsep
    from kd_cheap_conv_tpu_torch.ops import upsample as tup

    head = head_module(seed=seed)
    ref = stock_head(copy.deepcopy(head))
    r64 = stock_head(copy.deepcopy(head).double())
    feats = head_features(torch.float32, seed)
    ins = [{k: v.detach().clone().to(dt).requires_grad_()
            for k, v in feats.items()}
           for dt in (torch.float32, torch.float32, torch.float64)]
    fns = (tsep.run_separable, *tdec.PASSES, *tup.KERNELS, *tdw.KERNELS)
    for fn in fns:
        fn.launches = 0
    out = head(ins[0])
    want, w64 = ref(ins[1]), r64(ins[2])
    wo = torch.randn(out.shape, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(9))
    for o in (out, want, w64):
        (o * wo.to(o.dtype)).sum().backward()
    torch.cuda.synchronize()
    launches = {fn.__name__[4:]: fn.launches for fn in fns}

    def l2(a, b):
        return float((a.detach().double() - b.detach()).norm())

    scale = float(w64.detach().norm())
    res = {"values": l2(out, w64) / scale,
           "values_modules": l2(want, w64) / scale}
    trip = [(k, p.grad, q.grad, r.grad) for (k, p), q, r in zip(
        head.named_parameters(), ref.parameters(), r64.parameters())]
    trip += [(f"d {k}", ins[0][k].grad, ins[1][k].grad, ins[2][k].grad)
             for k in feats]
    floor = 1e-7 * max(float(c.norm()) for *_, c in trip)
    ratios = sorted(((l2(a, c) / (l2(b, c) + floor), k)
                     for k, a, b, c in trip), reverse=True)
    res["grads_vs_modules_noise"], res["grads_worst"] = (ratios[0][0],
                                                         ratios[:3])
    mods = dict(r64.named_modules())
    stats = [rel_err(getattr(m, a).double(), getattr(mods[k], a))[0]
             for k, m in head.named_modules()
             if isinstance(m, torch.nn.BatchNorm2d)
             for a in ("running_mean", "running_var")]
    res["stats"] = max(stats)
    ok = (launches == {"separable": 3, "sep_fwd": 1, "head_fwd": 1,
                       "head_bwd": 1, "sep_bwd": 1, "up_fwd": 1, "up_bwd": 1,
                       "dw_conv": 3, "dw_dx": 3, "dw_dk": 3}
          and len(stats) == 16 and res["values"] <= FEAT_TOL["values"]
          and res["stats"] <= FEAT_TOL["stats"]
          and res["grads_vs_modules_noise"] <= FEAT_TOL["grads_vs_noise"])
    phase("head_parity", what="the DeepLabV3+ head at batch 16 (low level "
          "129², ASPP input 33²): the kernels (f32) and _forward_modules "
          "with stock convs and upsample (f32) against _forward_modules in "
          "f64; TF32 off for cuDNN and matmuls", launches=launches, **res,
          tol=FEAT_TOL, ok=ok)
    if not ok:
        raise SystemExit("head_parity: the head disagrees with the module "
                         "path")


def head_times(g, total, bound, stock, card):
    """Phase head_time: each head kernel at config #2's shapes in bf16, the
    device time of its wrapper (the kernel, the weight casts and the
    partial-sum reduction), of its plain version and of the stock sequence
    it replaces (torch.profiler), and its bound; "sep" summed over the
    three ASPP branches (a KD step's launches). Then the whole head
    forward + backward (bf16, batch 16) through the kernels against the
    module path with stock convs and upsample, in turns (CUDA events)."""
    d = head_inputs(torch.bfloat16, g)
    for k in HEAD_KERNELS:
        t_ker = t_ref = t_stock = b_bytes = b_ops = 0.0
        for dil in (ASPP_DIL if k == "sep" else (None,)):
            kernel, plain, _ = head_fns(k, d, dil)
            with torch.no_grad():
                t_ker += device_ms_all(kernel)
                t_ref += device_ms_all(plain)
            t_stock += device_ms_all(head_stock(k, d, dil))
            bb, bo = head_bound_ms(k)
            b_bytes, b_ops = b_bytes + bb, b_ops + bo
        total[k, torch.bfloat16] = (t_ker, t_ref)
        bound[k] = [max(b_bytes, b_ops), b_bytes, b_ops]
        stock[k] = t_stock
        phase("head_time", kernel=k, dtype="bfloat16", ms=round(t_ker, 4),
              plain_ms=round(t_ref, 4), stock_ms=round(t_stock, 4),
              bound_ms=round(max(b_bytes, b_ops), 5),
              bound_by="bytes" if b_bytes >= b_ops else "operations",
              per_step_launches=HEAD_KERNELS[k][1], card=card)
    del d
    head = head_module(torch.bfloat16, seed=4)
    ref = stock_head(copy.deepcopy(head))
    feats = head_features(torch.bfloat16, 4)

    def step(m, backward):
        out = m(feats)
        if backward:
            out.float().sum().backward()

    rows = {}
    for what, bwd in (("forward", False), ("forward_backward", True)):
        t_k, t_m = paired_ms(lambda: step(head, bwd), lambda: step(ref, bwd),
                             reps=3)
        rows[what] = {"kernels_ms": round(t_k, 3), "modules_ms": round(t_m, 3)}
    phase("head_time", what="the DeepLabV3+ head, train mode, batch 16, "
          "bf16: separable, decoder, upsample and depthwise kernels vs the "
          "module path with stock convs and upsample, in turns", **rows,
          card=card)


def bf16_ulp(v):
    """One bf16 ulp at magnitude v (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def ulp_rel(want):
    """One bf16 ulp of want's largest magnitude, relative to it (the
    rel_err scale)."""
    top = float(want.detach().float().abs().max())
    return bf16_ulp(top) / top


def dw_geometries():
    """The depthwise convs of a config-#2 KD step, read from the student's
    train-mode forward at 513² (batch 1, then set to 16): [(label, (N, H, W,
    C), k, dilation, dtype)] for every Conv2d whose depthwise guard holds
    (features[8..17], bf16) and every separable ASPP branch (its backward
    recomputes the depthwise in f32)."""
    from kd_cheap_conv_tpu_torch.kd.replace import AtrousSeparableConvolution
    from kd_cheap_conv_tpu_torch.models.layers import Conv2d

    model = student(torch.bfloat16).train()
    geos, hooks = [], []
    for name, m in model.named_modules():
        def hook(mod, args, name=name):
            x = args[0]
            if isinstance(mod, AtrousSeparableConvolution):
                if not mod.fused_active():
                    return
                conv, dt = mod.depthwise, torch.float32
            elif mod.depthwise_active(x.dtype):
                conv, dt = mod, x.dtype
            else:
                return
            geos.append((name, (TRAIN_BATCH, x.shape[2], x.shape[3],
                                x.shape[1]), conv.kernel_size[0],
                         conv.dilation[0], dt))
        if isinstance(m, (AtrousSeparableConvolution, Conv2d)):
            hooks.append(m.register_forward_pre_hook(hook))
    x = torch.randn((1, 3, CROP, CROP), device="cuda").contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    # a separable branch's own depthwise is not called: the branch runs fused
    geos = [gm for gm in geos if not gm[0].endswith(".depthwise")]
    if len(geos) != RESAMPLE_KERNELS["dw_conv"][1]:
        raise SystemExit(f"dw_geometries: expected 13 depthwise convs in the "
                         f"step, found {geos}")
    return geos


def resample_fns(k, a, b, kk=None, dil=None):
    """(kernel wrapper call, plain version call) of upsample / depthwise
    kernel k on its inputs: up_fwd (x, size), up_bwd (g, input size),
    dw_conv (x, taps), dw_dx (g, taps), dw_dk (x, g)."""
    from kd_cheap_conv_tpu_torch.ops import dwconv as tdw
    from kd_cheap_conv_tpu_torch.ops import upsample as tup

    if k == "up_fwd":
        return (lambda: tup.run_up_fwd(a, b),
                lambda: tup.resize_bilinear_up_ref(a, b))
    if k == "up_bwd":
        return (lambda: tup.run_up_bwd(a, b),
                lambda: tup.resize_bilinear_up_bwd_ref(a, b))
    if k == "dw_conv":
        return (lambda: tdw.run_dw_conv(a, b, kk, dil),
                lambda: tdw.depthwise_conv2d_ref(a, b, kk, dil))
    if k == "dw_dx":
        return (lambda: tdw.run_dw_dx(a, b, kk, dil),
                lambda: tdw.depthwise_dx_ref(a, b, kk, dil))
    return (lambda: tdw.run_dw_dk(a, b, kk, dil),
            lambda: tdw.depthwise_dk_ref(a, b, kk, dil))


def resample_library(k, a, b, kk=None, dil=None, w=None):
    """The one PyTorch call computing kernel k's function on its inputs
    (NCHW views in channels_last memory); the step ran these before the
    kernels took over. up_fwd F.interpolate; up_bwd
    aten.upsample_bilinear2d_backward; dw_conv F.conv2d(groups=C); dw_dx
    and dw_dk aten.convolution_backward with only the input or only the
    weight mask set."""
    import torch.nn.functional as F

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    if k == "up_fwd":
        return lambda: F.interpolate(nchw(a), size=b, mode="bilinear",
                                     align_corners=False)
    if k == "up_bwd":
        n, ho, wo, c = a.shape
        return lambda: torch.ops.aten.upsample_bilinear2d_backward(
            nchw(a), [ho, wo], [n, c, b[0], b[1]], False, None, None)
    c, p = a.shape[-1], dil * (kk - 1) // 2
    if k == "dw_conv":
        return lambda: F.conv2d(nchw(a), w, None, 1, p, dil, c)
    # dw_dx: (g, taps), the input gradient needs only x's shape (g's);
    # dw_dk: (x, g)
    g, x, mask = ((a, a, [True, False, False]) if k == "dw_dx"
                  else (b, a, [False, True, False]))
    return lambda: torch.ops.aten.convolution_backward(
        nchw(g), nchw(x), w, None, [1, 1], [p, p], [dil, dil], False, [0, 0],
        c, mask)


def resample_bound_ms(k, shape, kk=None, dil=None, out_hw=None, esize=2):
    """Least time of upsample / depthwise kernel k on the card, as (bytes
    ms, FLOP ms): each input read once and each output written once in the
    activation dtype (esize bytes; the taps and dk f32); the multiplies and
    adds its data needs over the f32 peak outside the tensor cores (the
    upsample: 3 per element of each separable pass; the depthwise: 2 per
    in-image tap of each output, so a dilation past the image counts only
    the taps that land in it)."""
    n, h, w, c = shape
    if k in ("up_fwd", "up_bwd"):
        ho, wo = out_hw
        nbytes = esize * n * c * (h * w + ho * wo)
        flops = 3 * n * c * (ho * w + ho * wo)
    else:
        p = dil * (kk - 1) // 2
        taps = sum(max(0, h - abs(i * dil - p)) * max(0, w - abs(j * dil - p))
                   for i in range(kk) for j in range(kk))
        flops = 2 * n * c * taps
        nbytes = 2 * esize * n * h * w * c + 4 * kk * kk * c
    return nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3


def resample_inputs(dtype, g, geos):
    """Seeded inputs of the upsample and depthwise kernels at the step's
    shapes: [(kernel, label, a, b, k, dilation, weight (C, 1, k, k) for the
    library call)]: the upsample at batch 16 (the step) and 4 (serving),
    the depthwise at every geometry of `geos` (in `dtype`, whatever the
    step's); activations ~N(0, 1), taps ~N(0, 1/9) rounded to `dtype`."""
    def randn(*s, scale=1.0):
        return scale * torch.randn(s, device="cuda", generator=g)

    out = []
    for n in (TRAIN_BATCH, BATCH):
        x = randn(n, ASPP_HW, ASPP_HW, CU).to(dtype)
        gy = randn(n, HEAD, HEAD, CU).to(dtype)
        out.append(("up_fwd", f"b{n}", x, (HEAD, HEAD), None, None, None))
        out.append(("up_bwd", f"b{n}", gy, (ASPP_HW, ASPP_HW), None, None,
                    None))
    for label, shape, kk, dil, _ in geos:
        x, gg = randn(*shape).to(dtype), randn(*shape).to(dtype)
        w = randn(shape[-1], 1, kk, kk, scale=1 / kk).to(dtype)
        taps = w.float().reshape(shape[-1], kk * kk).t().contiguous()
        out += [("dw_conv", label, x, taps, kk, dil, w),
                ("dw_dx", label, gg, taps, kk, dil, w),
                ("dw_dk", label, x, gg, kk, dil, w)]
    return out


def resample_dw_parity(g, worst, geos):
    """Phase resample_dw_parity: the upsample kernels at 16 and 4 x 33² x
    256 -> 129², and the depthwise conv, dx and dk at each of the step's 13
    geometries, f32 (TF32 off) and bf16, against their plain versions: f32
    max abs error RESAMPLE_TOL of the largest plain magnitude, bf16 one ulp
    of it (dk compared after the rounding to bf16 the step gives it); dk
    twice, bit for bit."""
    for dtype in (torch.float32, torch.bfloat16):
        for k, label, a, b, kk, dil, _ in resample_inputs(dtype, g, geos):
            kernel, plain = resample_fns(k, a, b, kk, dil)
            with torch.no_grad():
                got, want = kernel(), plain()
                second = kernel() if k == "dw_dk" else got
            torch.cuda.synchronize()
            twice = torch.equal(got, second)
            if k == "dw_dk":
                got, want = got.to(dtype), want.to(dtype)
            rel, err = rel_err(got, want)
            tol = (RESAMPLE_TOL if dtype == torch.float32 else ulp_rel(want))
            ok = rel <= tol and twice
            worst[k, dtype] = max(worst.get((k, dtype), 0.0), err)
            phase("resample_dw_parity", kernel=k, at=label,
                  shape=list(a.shape), k=kk, dilation=dil,
                  dtype=str(dtype)[6:], rel_err=rel, max_abs_err=err,
                  tol=tol, twice_bit_identical=twice if k == "dw_dk" else None,
                  ok=ok)
            if not ok:
                raise SystemExit(f"resample_dw parity failed: {k} at {label} "
                                 f"{dtype}")
            del got, want, second


def resample_dw_times(g, geos, total, bound, stock, library, card):
    """Phase resample_dw_time: each upsample and depthwise kernel summed over
    its launches in one KD step (up_fwd twice at batch 16, up_bwd once, the
    depthwise at the step's 13 geometries in the step's dtypes: bf16 for
    features[8..17], f32 for the ASPP recompute): the device time of its
    wrapper, of its plain version and of the one PyTorch call computing its
    function (torch.profiler), which is also the stock call the step ran
    before (stock_ms = library_ms), and its bound."""
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        want = [gm for gm in geos if gm[4] == dtype]
        for k, label, a, b, kk, dil, w in resample_inputs(dtype, g, want):
            per_step = 2 if k == "up_fwd" else 1
            if k.startswith("up") and (dtype != torch.bfloat16
                                       or label != f"b{TRAIN_BATCH}"):
                continue
            kernel, plain = resample_fns(k, a, b, kk, dil)
            with torch.no_grad():
                t_ker = device_ms_all(kernel)
                t_ref = device_ms_all(plain)
                t_lib = device_ms_all(resample_library(k, a, b, kk, dil, w))
            shape = tuple(a.shape) if k != "up_bwd" else (
                a.shape[0], *b, a.shape[-1])
            out_hw = b if k == "up_fwd" else tuple(a.shape[1:3])
            bb, bo = resample_bound_ms(k, shape, kk, dil, out_hw,
                                       a.element_size())
            r = rows.setdefault(k, [0.0] * 5)
            for i, v in enumerate((t_ker, t_ref, t_lib, bb, bo)):
                r[i] += per_step * v
    for k, (t_ker, t_ref, t_lib, bb, bo) in rows.items():
        total[k, torch.bfloat16] = (t_ker, t_ref)
        bound[k] = [max(bb, bo), bb, bo]
        stock[k] = library[k] = t_lib
        phase("resample_dw_time", kernel=k, ms=round(t_ker, 4),
              plain_ms=round(t_ref, 4), library_ms=round(t_lib, 4),
              stock_ms=round(t_lib, 4), bound_ms=round(max(bb, bo), 5),
              bound_by="bytes" if bb >= bo else "operations",
              per_step_launches=RESAMPLE_KERNELS[k][1], card=card)


def device_ms_all(fn, iters=5, rounds=3):
    """Device time per call (ms) of every kernel fn launches, from
    torch.profiler; the median of three rounds."""
    fn()
    runs = []
    for _ in range(rounds):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        runs.append(sum(e.device_time_total for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA) / iters / 1e3)
    return statistics.median(runs)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from kd_cheap_conv_tpu_torch import native
    from kd_cheap_conv_tpu_torch.ops import decoder as tdec
    from kd_cheap_conv_tpu_torch.ops import dwconv as tdw
    from kd_cheap_conv_tpu_torch.ops import irchain_eval as ire
    from kd_cheap_conv_tpu_torch.ops import losses_fused as lf
    from kd_cheap_conv_tpu_torch.ops import separable as tsep
    from kd_cheap_conv_tpu_torch.ops import stem as tst
    from kd_cheap_conv_tpu_torch.ops import tstem as tts
    from kd_cheap_conv_tpu_torch.ops import upsample as tup

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi("name,power.limit")
    sm_clock = float(smi("clocks.max.sm", "csv,noheader,nounits"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kernels = {"A": ire.fused_mnv2_blocks_eval, "B": ire.fused_ir_block_s2_eval,
               "C": lf.ce_kl_upsampled_fwd, "D": lf.ce_kl_upsampled_bwd,
               **{k: getattr(tst, f"run_{k}") for k in PASSES},
               **{k: getattr(tst, f"run_{k}") for k in ENTRY if k != "tstem"},
               "tstem": tts.fused_stem_pool_eval, "sep": tsep.run_separable,
               **{k: getattr(tdec, f"run_{k}") for k in HEAD_KERNELS if k != "sep"},
               "up_fwd": tup.run_up_fwd, "up_bwd": tup.run_up_bwd,
               "dw_conv": tdw.run_dw_conv, "dw_dx": tdw.run_dw_dx,
               "dw_dk": tdw.run_dw_dk}
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

    # 4. the pass kernels, at every geometry, the entry kernels, then the
    # whole chains from the image
    chain_parity(g, worst)
    entry_parity(g, worst)
    features_parity()
    head_parity(g, worst)
    head_module_parity()
    geos = dw_geometries()
    resample_dw_parity(g, worst, geos)

    # 5. the serving path, counted from zero
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
              launches_up_fwd=got["up_fwd"], wall_s=round(wall, 2))
        if got != {"A": 14 * fwd, "B": 3 * fwd, "C": 0, "D": 0,
                   **{k: 0 for k in PASSES}, **{k: 0 for k in ENTRY},
                   "sep": 4 * fwd, **{k: 0 for k in HEAD_KERNELS if k != "sep"},
                   "up_fwd": fwd, **{k: 0 for k in RESAMPLE_KERNELS
                                     if k != "up_fwd"}}:
            raise SystemExit(f"expected {14 * fwd} A, {3 * fwd} B, "
                             f"{4 * fwd} separable and {fwd} up_fwd launches "
                             f"and no pass, entry, decoder, up_bwd or "
                             f"depthwise launch, got {got}")
        for k in "AB":
            launches[k] += got[k]

    from kd_cheap_conv_tpu_torch.data import SyntheticSegmentation

    val = SyntheticSegmentation(N_CLS, size=CROP, length=N_VAL, seed=2)
    imgs = torch.stack([torch.from_numpy(val[i][0]) for i in range(2)])
    x = imgs.float().cuda().permute(0, 3, 1, 2)
    # the kernel path (eval, no autograd: A, B, the separable kernel and the
    # upsample) against the plain path: autograd on, so every backbone block
    # runs its own module, and the separable, depthwise and upsample kernels
    # turned off, so those run cuDNN and F.interpolate; the plain path
    # launches no kernel of the port
    with torch.no_grad():
        fused = model(x)
    for fn in kernels.values():
        fn.launches = 0
    plain = stock_model(model)(x).detach()
    torch.cuda.synchronize()
    in_plain = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    err = float((fused - plain).abs().max())
    scale = float(plain.abs().max())
    agree = float((fused.argmax(1) == plain.argmax(1)).float().mean())
    phase("logits", shape=list(fused.shape), max_abs_err=err,
          max_abs_logit=scale, argmax_agree=agree,
          plain_path_launches=in_plain)
    if not (torch.isfinite(fused).all() and err <= 1e-3 * max(1.0, scale)
            and agree >= 0.999 and not in_plain):
        raise SystemExit("full-model logits: kernel path and plain path "
                         f"disagree (plain path launched {in_plain})")
    del model, fused, plain

    # 6. the training path (config #2 KD, 4 steps), counted from zero
    from kd_cheap_conv_tpu_torch import main as port_main

    with tempfile.TemporaryDirectory() as ckpt_dir:
        for fn in kernels.values():
            fn.launches = 0
        tdw.depthwise_conv2d.layout_copies = 0
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
          launches=got, losses=losses, checkpoints=ckpts,
          depthwise_layout_copies=tdw.depthwise_conv2d.layout_copies)
    latest = "latest_deeplabv3plus_mobilenet_synthetic_os16.pth"
    if rc != 0 or not losses or not all(map(math.isfinite, losses)):
        raise SystemExit(f"train: rc {rc}, losses {losses}")
    if got["C"] != TRAIN_STEPS or got["D"] != TRAIN_STEPS:
        raise SystemExit(f"train: expected {TRAIN_STEPS} C and D launches "
                         f"(one each per step), got {got}")
    if got["A"] != 14 * forwards or got["B"] != 3 * forwards:
        raise SystemExit(f"train: the validation at the end ran "
                         f"{got['A']} A and {got['B']} B launches")
    want_passes = {k: v[1] * TRAIN_STEPS for k, v in PASSES.items()}
    if {k: got[k] for k in PASSES} != want_passes:
        raise SystemExit(f"train: expected {want_passes} pass launches "
                         f"(11 / 4 / 2 forward and backward per step), got "
                         f"{got}")
    want_entry = {k: v[1] * TRAIN_STEPS for k, v in ENTRY.items()}
    if {k: got[k] for k in ENTRY} != want_entry:
        raise SystemExit(f"train: expected {want_entry} entry launches (f0 "
                         f"forward, weight gradient, no image gradient, the "
                         f"teacher stem: 1 / 1 / 0 / 1 per step), got {got}")
    want_head = {k: v[1] * TRAIN_STEPS for k, v in HEAD_KERNELS.items()}
    want_head["sep"] += 4 * forwards              # the final validation
    if {k: got[k] for k in HEAD_KERNELS} != want_head:
        raise SystemExit(f"train: expected {want_head} head launches (3 "
                         f"separable and one each of P1, P2, B1, B2 per "
                         f"step, 4 separable per validation forward), got "
                         f"{got}")
    want_resample = {k: v[1] * TRAIN_STEPS
                     for k, v in RESAMPLE_KERNELS.items()}
    # the student's decoder in the final validation, and the teacher's in the
    # one train-mode pass that calibrates its BN statistics
    want_resample["up_fwd"] += forwards + 1
    if {k: got[k] for k in RESAMPLE_KERNELS} != want_resample:
        raise SystemExit(f"train: expected {want_resample} upsample and "
                         f"depthwise launches (up_fwd 2, up_bwd 1, 13 each "
                         f"of the depthwise conv, dx and dk per step; up_fwd "
                         f"once per validation forward and in the teacher's "
                         f"calibration), got {got}")
    if latest not in ckpts:
        raise SystemExit(f"train: no {latest} in {ckpts}")
    for k in ("C", "D", *PASSES, *ENTRY, *HEAD_KERNELS, *RESAMPLE_KERNELS):
        launches[k] = got[k]

    # 7. times: validate and the KD step first, untraced and before any
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

    # the teacher's forward with and without its stem kernel, in turns
    tb = kd_teacher.backbone

    def teacher_forward():
        with torch.no_grad():
            kd_teacher(t_images, class_major=True, upsample=False)

    def teacher_forward_modules():
        tb._fused_stem_eval_active = lambda: False
        try:
            teacher_forward()
        finally:
            del tb._fused_stem_eval_active

    t_stem, t_mod = paired_ms(teacher_forward, teacher_forward_modules,
                              reps=3)
    phase("teacher_time", what="teacher forward (ResNet-101 DeepLabV3+, "
          "eval, no_grad), 513², batch 16, bf16", stem_kernel_ms=round(
              t_stem, 3), module_stem_ms=round(t_mod, 3), card=card)

    # no convolution with a 3-channel input is left in the step
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        kd_step(t_images, t_labels)
        torch.cuda.synchronize()
    conv3 = sorted({e.key for e in prof.key_averages(group_by_input_shape=True)
                    if "conv" in e.key.lower() and any(
                        isinstance(sh, list) and len(sh) == 4 and sh[1] == 3
                        for sh in e.input_shapes)})
    phase("train_convs", what="one profiled KD step: ops named conv* with a "
          "4-D operand of 3 channels", found=conv3, ok=not conv3)
    if conv3:
        raise SystemExit(f"train: the KD step still runs {conv3} on the "
                         f"3-channel image")

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
    calls = {}
    for inst, tt in (("kl", t), ("ce", None)):
        calls["C", inst] = (
            lambda tt=tt: lf.ce_kl_upsampled_fwd(s, tt, lbl, *loss_args),
            lambda tt=tt: lf.ce_kl_upsampled_fwd_ref(s, tt, lbl, *loss_args))
        calls["D", inst] = (
            lambda tt=tt: lf.ce_kl_upsampled_bwd(s, tt, lbl, scales,
                                                 *loss_args),
            lambda tt=tt: lf.ce_kl_upsampled_bwd_ref(s, tt, lbl, scales,
                                                     *loss_args))
    for (k, inst), (kfn, pfn) in calls.items():
        w_ker, w_ref = paired_ms(kfn, pfn, reps=3)
        t_ker, t_ref = device_ms(kfn, pfn, name=LOSS_KERNELS[k], iters=5)
        b_ms, b_by = loss_bound_ms(k, s, t if inst == "kl" else None, lbl,
                                   sm_clock, sms)
        if inst == "kl":                  # the KD step's instance
            total[k, torch.bfloat16] = (t_ker, t_ref)
            bound[k] = [b_ms] + ([1.0, 0.0] if b_by == "bytes"
                                 else [0.0, 1.0])
        phase("loss_time", kernel=k, instance=inst, shape=list(s.shape),
              out=[CROP, CROP], dtype="bfloat16", ms=round(t_ker, 4),
              plain_ms=round(t_ref, 4), wall_ms=round(w_ker, 4),
              plain_wall_ms=round(w_ref, 4), bound_ms=round(b_ms, 5),
              bound_by=b_by, sm_clock_max_mhz=sm_clock, card=card)
    del s, t, lbl
    # the pass kernels at each geometry (bf16), the entry kernels, and
    # features[0..6]
    pass_times(g, total, bound)
    stock = {}
    entry_times(g, total, bound, stock, card)
    features_times(card)
    head_times(g, total, bound, stock, card)
    library = {}
    resample_dw_times(g, geos, total, bound, stock, library, card)

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
        teacher_split, _, t_rounds = device_split(lambda: kd_teacher(
            t_images, class_major=True, upsample=False),
            {ENTRY["tstem"][0]: 1, RESAMPLE_KERNELS["up_fwd"][0]: 1})
    step_split, top_other, s_rounds = device_split(
        lambda: kd_step(t_images, t_labels), step_kernel_launches())
    step_busy = sum(step_split.values())
    kd_split = {"loss_CD": step_split["loss_CD"],
                "teacher_convs": teacher_split["convs"],
                "student_convs": step_split["convs"] - teacher_split["convs"],
                "bn_passes": step_split["bn_passes"],
                "entry": step_split["entry"], "head": step_split["head"],
                "resample_dw": step_split["resample_dw"],
                "bn": step_split["bn"], "other": step_split["other"]}
    phase("train_profile", what="one KD step, 513², batch 16, bf16",
          device_ms={k: round(v, 3) for k, v in kd_split.items()},
          teacher_forward_ms={k: round(v, 3)
                              for k, v in teacher_split.items()},
          top_other=top_other, profiled_rounds={"teacher": t_rounds,
                                                "step": s_rounds},
          device_busy_ms=round(step_busy, 3),
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
                     "kd_cheap_conv_tpu/ops/pallas/losses.py:537"),
               **{k: (f"{k} ({v[0]})", PASS_SRC, v[2])
                  for k, v in PASSES.items()},
               **{k: (f"{k} ({v[0]})", ENTRY_SRC, v[2])
                  for k, v in ENTRY.items()},
               **{k: (f"{k} ({v[0]})", HEAD_SRC, v[2])
                  for k, v in HEAD_KERNELS.items()},
               **{k: (f"{k} ({v[0]})", RESAMPLE_SRC, v[2])
                  for k, v in RESAMPLE_KERNELS.items()}}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": where,
         "launches": launches[k],
         "max_abs_err": worst[k, torch.float32],
         "max_abs_err_bf16": worst[k, torch.bfloat16],
         "ms": round(total[k, torch.bfloat16][0], 4),
         "plain_ms": round(total[k, torch.bfloat16][1], 4),
         "bound_ms": round(bound[k][0], 5),
         "bound_by": "bytes" if bound[k][1] >= bound[k][2] else "operations",
         "library_ms": (round(library[k], 4) if k in library else None),
         **({"stock_ms": round(stock[k], 4)} if k in stock else {})}
        for k, (name, src, where) in entries.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
