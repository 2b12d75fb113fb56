#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on a CUDA card.

    python3 chip_smoke.py

Drives kd_cheap_conv_tpu_torch (never JAX) on one card, in phases; each
prints its result as JSON lines (`t_s`: seconds since the script started),
and any failure exits non-zero:

1. build       — compile the CUDA kernels from csrc/ (nvcc, sm_90a, one
                 process per source).
2. parity      — kernel A (stride-1 eval IR block) and kernel B (stride-2)
                 on all 17 block geometries of the 513² student at OS16,
                 batch 4, against their plain PyTorch versions, in f32
                 (TF32 off) and bf16, each output twice, bit for bit.
3. loss_parity — kernel C (fused upsample + CE + KL, forward) and kernel D
                 (its backward) against their plain versions in f64 at
                 config #2's shape, (16, 21, 129, 129) -> 513², int64
                 labels with ~5% void, a teacher spanning +-1e5 (the clip
                 binds), KL and CE-only instances, f32 and bf16 inputs,
                 ds twice, bit for bit (config #3's shape follows
                 x_step_geometries, below).
4. chain_parity — the six BN-barrier pass kernels (csrc/bn_passes.cu)
                 against their plain versions at every geometry of the
                 config-#2 path (17 forward and 17 backward passes of the
                 train-mode stem and IR chain at batch 16, 513²), f32 (TF32
                 off) and bf16.
   entry_parity — the four image-entry kernels (csrc/entry_convs.cu: the
                 student's entry conv forward, weight and image gradient,
                 the teacher's eval stem + maxpool) against their plain
                 versions at config #2's shapes (16 x 513² x 3), f32 and
                 bf16, the weight gradient twice, bit for bit, the image
                 gradient also at an odd-by-even size, and the bf16 stem
                 against an f64 run of its own operands (one ulp of each
                 output's magnitude plus the f32 sum's error bound); then
                 features[0..6]
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
   rchain_parity — the teacher's whole f32 forward (ResNet-101 DeepLabV3+,
                 16 x 513², TF32 off) through its stem, bottleneck
                 (csrc/rchain_eval.cu) and upsample kernels and through its
                 module path, both against the module path in f64: logits
                 and both backbone taps within 1e-4 of their largest value
                 or 3x the f32 module path's own error, 6 bottleneck
                 launches; then the bottleneck
                 kernel against its plain version at the six block
                 geometries of that forward, f32 (1e-4) and bf16 (1.6e-2 of
                 the largest value), twice, bit for bit.
   cached_loss_parity — the full-resolution CE + KL forward and backward
                 kernels (csrc/ce_kl.cu) against their plain versions at
                 config #1's (16, 21, 513, 513), f32 and bf16 student
                 logits, the teacher as the cache delivers it (float16 NHWC)
                 and as float32 class-major, then bf16 with edge labels
                 (outside [0, C), negative, an all-void image), within
                 LOSS_TOL; the sums and ds twice, bit for bit.
   x_step_geometries — one config-#3 KD step (Xception-65 teacher and
                 student, 4 x 769², bf16), every kernel call recorded: the
                 chains' 63 / 60 / 3 pass calls each way, the teacher's
                 eval entry blocks' 9 / 6 / 3 forward pass calls and 54
                 folded sep convs, and the head's, separable conv's,
                 upsample's, depthwise conv's and loss's geometries. At those, head_parity (P1/P2/B1/B2 at 4 x 193²,
                 48 + 256 -> 256 -> 19; the separable conv 4 x 49² x 2048
                 -> 256 at dilations 6, 12, 18), loss_parity (4 x 19 x 193²
                 -> 769²: 769 is prime, so the row tiles are masked) and
                 resample_dw_parity (the upsample 4 x 49² x 256 -> 193², the
                 depthwise conv, dx and dk at 4 x 49² x 2048, f32, at
                 dilations 6, 12, 18) run again with the same limits.
   xpass_parity — the pass kernels of the config-#3 Xception chains (the
                 wide 1x1 forward, its dgrad and wgrad, csrc/wide_pw.cu; the
                 depthwise passes with relu, dilation 2 and up to 1536
                 channels, csrc/bn_passes.cu) against their plain versions
                 at every distinct geometry of the student's forward and
                 backward at 4 x 769² (read from the chains' calls: 63 / 60
                 / 3 forward and backward; the teacher's eval entry passes
                 as they run, without moments), f32 (TF32 off) and bf16
                 within PASS_TOL, every output twice, bit for bit.
   xception_parity — the config-#3 student's backbone, full depth, one
                 train-mode step at 4 x 769² through the chains in f32 and
                 through its module path in f32, both against the module
                 path in f64 (X_TOL): out and low_level, every parameter
                 gradient, the running statistics of all 132 BNs; the
                 chains' launches 63 / 60 / 3 each way, no narrow 1x1.
   xeval_parity — the eval chains' folded separable conv
                 (csrc/xchain_eval.cu: in bf16 the depthwise pass
                 xsep_dw_kernel and the TMA + wgmma product xsep_mm_kernel,
                 in f32 xsep_eval_kernel over csrc/sep_conv.cuh) against
                 its plain version at every distinct geometry of the
                 config-#3 teacher's forward (read from its 54 calls: 4 x
                 49², dilation 1 and 2, the residual, the exit block's 1x1
                 skip, the final relu, 728 .. 2048 channels, f32 and bf16
                 inputs and outputs) and at OS8's exit-block skip conv (4 x
                 97², dilation 4), f32 (TF32 off) and bf16 within PASS_TOL,
                 twice, bit for bit, each kernel's launches counted (bf16:
                 one depthwise pass and one product a sep conv, no f32
                 kernel); in bf16 each of the two kernels also alone
                 against its plain version.
   xception_eval_parity — the full-depth backbone in eval mode under
                 no_grad at 4 x 769² (calibrated BN statistics) through the
                 eval chains in f32 and through its module path in f32,
                 both against the module path in f64: out and low_level,
                 the chains within 2x the module path's own error
                 (X_EVAL_TOL); exactly 54 f32 folded sep-conv, 9 wide 1x1,
                 6 depthwise and 3 stride-2 depthwise launches per forward,
                 no other kernel of the port.
   x8_parity   — config #3 at OS8 (`--output_stride 8`: the middle flow
                 at 4 x 97² x 728, dilation 2; the exit flow at 97²,
                 dilation 4; block3 at stride 1 on its modules; ASPP rates
                 12/24/36): x_step_geometries(8) records one OS8 step (60 /
                 58 / 2 student pass calls each way, 6 + 6 of them the
                 dilation-4 depthwise forward and backward, 48 + 48 at
                 dilation 2; the teacher's 6 / 4 / 2 eval entry passes),
                 then every geometry OS16 did not cover is checked as
                 above: the pass kernels (the dilation-4 instances in rows
                 of their own, moments, sums and dk twice bit for bit),
                 the separable conv at 4 x 97² x 2048 -> 256, dilations
                 12, 24, 36, the upsample 97² -> 193², the depthwise
                 recompute, dx and dk there, the folded sep convs at 97².
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
   main_x      — Xception serving, `main --test_only --model
                 deeplabv3plus_xception` at 769², batch 4, bf16, plain
                 validate and TTA: a finite mIoU, exactly 54 depthwise-pass
                 and 54 product launches (the bf16 sep convs), 9 wide 1x1,
                 6 + 3 depthwise, 4 separable and 1 upsample launches per
                 forward and no other; then (x_logits) f32 logits of a
                 calibrated model through the eval chains against the fully
                 stock path (autograd on, no kernel of the port), 1e-3 x
                 max(1, max |logit|), argmax agreement >= 99.9%; and
                 (x_logits_bf16) the bf16 model's logits through the eval
                 chains against the same model with each sep conv on
                 xsep_eval_ref and against a path of f64 products: finite,
                 max abs error over max |logit| and the argmax agreements
                 reported; on the robust pixels (the f64 path's top-2
                 margin above twice the plain path's largest abs
                 difference from it, their share reported) the kernel
                 path's argmax equals the f64 path's at 100%: no flip,
                 counted in integers. Then all of main_x again at OS8
                 (`--output_stride 8`: 6 wide 1x1 and 4 + 2 depthwise
                 launches per forward, the entry block3 on its modules).
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
                 in the validation, 6 bottleneck launches per step (on the
                 teacher's NHWC memory, no layout copy), the latest
                 checkpoint; and no convolution with a 3-channel input left
                 in a profiled KD step.
   train_x     — the config-#3 KD command (Xception-65 teacher and student,
                 19 classes, 769², batch 4, bf16, OS16) through `main.main`,
                 4 steps, validation at the end: finite losses, the latest
                 checkpoint, and every kernel's exact launch count (per
                 step 63 wide 1x1 forward, dgrad and wgrad, 60 + 3 depthwise
                 forward and backward, 3 separable, one each of P1/P2/B1/B2,
                 C and D, 2 up_fwd, 1 up_bwd, 3 each of the depthwise conv,
                 dx and dk, and the teacher's eval forward: 54 depthwise
                 passes and 54 products (its bf16 folded sep convs), 9
                 wide 1x1, 6 + 3 depthwise; the teacher's
                 calibration pass and the validation's eval forwards on
                 top; no A, B, narrow 1x1, f0, teacher-stem or bottleneck
                 launch); then the same command at OS8 (per step 60 wide
                 1x1 each way plus the teacher's 6, 58 + 2 depthwise each
                 way, 6 of each at dilation 4, counted by instance).
   cached      — config #1 through the functions `main --kd --cached_logits`
                 calls: the teacher's logits over 32 synthetic 513² images
                 into a temporary cache (1 teacher-stem, 6 bottleneck and 1
                 upsample launch per teacher batch of 16), the cached
                 dataset, 2 cached KD steps at batch 16, bf16 in
                 `train_loop` (finite losses; 1 full-resolution forward and
                 1 backward launch per step, no C, D or teacher kernel);
                 then the cached step's images/s and device split.
7. times       — validate images/s and KD-step images/s on device-resident
                 batches, untraced and before any profiler session; each
                 block's kernel, kernels C and D (KL and CE-only; and the
                 KL instance at config #3's 4 x 19 x 193² -> 769²), the
                 pass kernels at each of their geometries and the entry
                 kernels against their plain versions (the entry kernels
                 and the narrow 1x1 passes also against the stock
                 sequences they replace, the 1x1 passes against their
                 torch.matmul products, `pass_step`): device time
                 (torch.profiler) and, for A-D, wall time per call (CUDA
                 events); the host microseconds per call of the
                 redesigned wrappers, the narrow 1x1 forward and
                 backward, the wide 1x1, the depthwise forward, B1, B2,
                 C, D and the bottleneck (200 back-to-back calls without
                 synchronising, `host_us` in `pass_time`, `xpass_time`,
                 `head_time`, `loss_time` and `rchain_time`); the
                 depthwise forward's and the wide kernels' time per
                 config-#3 geometry (`xpass_geometry`); features[0..6] forward and backward from
                 the image, the chains with the entry-conv kernels against
                 the cuDNN entry conv + chains and against the module path,
                 the head kernels against their plain versions and the
                 stock sequences they replace (the separable conv and P1
                 by CUDA events in turns, the profiler's reading beside
                 them; the fuse conv in a row of its own; the separable
                 conv's three 2048-wide branches, P1, B1 and B2 also at
                 config #3's geometry), the whole head forward and
                 backward against the module path (`head_time`), the
                 upsample and depthwise kernels summed per KD step against
                 their plain versions and the one PyTorch call computing
                 each, dk also over config #3's three launches
                 (`resample_dw_time`), the bottleneck kernel per block
                 and per teacher forward against its plain version and the
                 blocks' modules (`rchain_time`), the full-resolution loss
                 kernels against their plain versions (CUDA events, in
                 turns, and the profiler's reading beside them) and the
                 F.cross_entropy + F.kl_div pair, with each wrapper's host
                 µs (`cached_loss_time`),
                 and the teacher's forward with and without its stem kernel
                 and with and without its bottleneck kernel (CUDA events, in
                 turns); one profiled validate pass and one
                 profiled KD step split by kernel class, with the device's
                 idle share (the step's profile must hold every kernel of
                 the port it launches, as often as it launches it) and the
                 head class by kernel (`head_ms_by_kernel`, also in
                 `cached_rate` and `x_profile`). Config
                 #3: its KD step's images/s and peak memory (`x_rate`), each
                 Xception pass kernel summed per step against its bound, its
                 plain version, the stock sequence it replaces and the one
                 PyTorch call computing its product or conv alone
                 (torch.matmul for the wide 1x1 kernels, `product_ms`;
                 `xpass_time`; the wide 1x1 backward kernels also per
                 geometry, `xpass_geometry`), the folded sep conv's two kernels per
                 teacher forward (on the path inside profiled forwards,
                 each kernel and their sum; each geometry alone with warm
                 and with cold L2) against their bounds (and the sum
                 against the bound of the blocks and segments the pair
                 replaces), their plain versions, torch.matmul of the
                 products and F.conv2d of the depthwise convs, and the
                 middle- and exit-flow modules they replace
                 (`xeval_time`), the
                 teacher's forward with and without the eval chains (CUDA
                 events, in turns, three readings; `xteacher_time`), and
                 its step by
                 kernel class (`x_profile`: `xeval`, `wide_pw`,
                 `bn_passes`). Config #3 at OS8: `x_rate` and `x_profile`
                 again (the profile must hold the 6 + 6 dilation-4
                 launches by instance name), and the dilation-4
                 instances over their calls in the step by CUDA events in
                 turns with their plain versions, against their bound,
                 stock sequence and conv alone (`x8_d4_time`, per geometry
                 `x8_d4_geometry` with the forward's plan).
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
# kernels C/D against their plain versions in f64 on the same inputs: on
# the card F.interpolate takes its source coordinates in the input's
# precision, in f32 up to ~1.5e-5 off at 769 outputs, so an f32 plain
# version is no yardstick at config #3. One tolerance serves both dtypes
# (bf16 inputs are widened first; ds is compared after the rounding to bf16
# both take). The teacher here sits at the clip, |t|/T = 7500, where one
# f32 ulp of t/T is ~5e-4 on a per-pixel KL of ~3: the sums get rtol 1e-4,
# and ds an absolute floor of 1e-7
LOSS_TOL = {"values": 1e-4, "ds_rtol": 1e-4, "ds_atol": 1e-7}
# kernels C/D at config #2: head-resolution logits (N, classes, h, w) and
# the arguments after the labels (out_h, out_w, T, ignore index, clip)
LOSS_GEO = {"at": "config #2", "shape": (TRAIN_BATCH, N_CLS, HEAD, HEAD),
            "args": (CROP, CROP, 4.0, 255, 3e4)}
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
# branches, the other four the fused decoder head's passes P1, P2, B1, B2.
# In bf16 "sep" and P1 are two kernel functions of one design
# (spf::sep_conv_kernel, spf::sep_fwd_kernel), so profiles tell them apart
HEAD_KERNELS = {
    "sep": ("sep_conv_kernel", 3,
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
# the head kernels' geometry at config #2 (head_inputs): batch, head size,
# low-level and upsampled channels, Cm, classes, and the separable convs by
# dilation as (input NHWC, Co): the ASPP branches and, at dilation 1, the
# serving decoder's fuse conv. Config #3's is read from its step
# (x_step_geometries)
HEAD_GEO = {"at": "config #2", "n": TRAIN_BATCH, "hw": (HEAD, HEAD),
            "cl": CL, "cu": CU, "cm": CM, "ncls": N_CLS,
            "sep": {**{d: ((TRAIN_BATCH, ASPP_HW, ASPP_HW, ASPP_C), CM)
                       for d in ASPP_DIL},
                    1: ((BATCH, HEAD, HEAD, CL + CU), CM)}}
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
RCHAIN_SRC = "kd_cheap_conv_tpu_torch/csrc/rchain_eval.cu"
CEKL_SRC = "kd_cheap_conv_tpu_torch/csrc/ce_kl.cu"
# the teacher's eval bottleneck kernel: its kernel function, launches per
# teacher forward (layer1's 3 blocks, layer2's last 3), the TPU kernel it
# replaces (rchain.py; rchain_hwnc.py:141 is its twin)
BNECK = ("bneck_eval_kernel", 6, "kd_cheap_conv_tpu/ops/pallas/rchain.py:133")
# the cached step's full-resolution loss kernels: kernel function, launches
# per cached step, the TPU kernel it replaces
FULL_LOSS = {"ce_kl_fwd": ("ce_kl_fwd_kernel", 1,
                           "kd_cheap_conv_tpu/ops/pallas/losses.py:33"),
             "ce_kl_bwd": ("ce_kl_bwd_kernel", 1,
                           "kd_cheap_conv_tpu/ops/pallas/losses.py:80")}
# bottleneck kernel vs plain, max abs error over max |plain|: f32 (TF32 off)
# sums up to 9 x 128 + 512 products in another order; bf16 rounds h1, h2
# and y to bf16 on both sides, where a last-ulp f32 difference can round
# them apart
RCHAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
# the teacher's whole f32 forward through its kernels and through its module
# path, each against the module path in f64 (max abs error over max |f64|
# per output): the kernel path within 1e-4 or 3x the module path's own f32
# error, whichever is larger. 29 blocks after layer2 carry the blocks'
# rounding differences to ~5e-4 of the logits: the random teacher's deep
# layers amplify any f32 noise (the module path's own included)
TEACHER_TOL = {"floor": 1e-4, "vs_noise": 3.0}
CACHED_IMAGES = 32          # the cache build's synthetic train set
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 FLOP/s, f32
# FLOP/s outside the tensor cores; the special-function unit gives 16 exp
# results per clock per SM
HBM_BPS, BF16_FLOPS, F32_FLOPS, MUFU_PER_CLK_SM = 3.35e12, 989e12, 67e12, 16
CONV_WORDS = ("conv", "gemm", "xmma", "nvjet", "cutlass", "implicit",
              "sm90_", "wgrad", "dgrad")
BN_WORDS = ("batch_norm", "batchnorm", "welford", "bn_fw", "bn_bw")


T_START = time.perf_counter()


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields,
                      "t_s": round(time.perf_counter() - T_START, 1)}),
          flush=True)


def share_of(mask):
    """The share of True in a bool tensor, from integer counts: a float mean
    on the card scales by a rounded 1/n, so it can read 1 - 2**-24 where
    every element is True."""
    return int(mask.sum()) / mask.numel() if mask.numel() else 1.0


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


def calibrate_bn(model, seed, size=CROP, n_cls=N_CLS):
    """Seeded random BN affine parameters, then running statistics from one
    train-mode pass (cumulative average, so exactly that batch's moments)
    over two synthetic images of `size`² (513² by default), computed on the
    card; the model is left in eval mode on the device it came on."""
    from kd_cheap_conv_tpu_torch.data import SyntheticSegmentation

    g = torch.Generator().manual_seed(seed)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        c = bn.num_features
        bn.weight.data = 1 + 0.2 * torch.randn(c, generator=g)
        bn.bias.data = 0.1 * torch.randn(c, generator=g)
        bn.reset_running_stats()
        bn.momentum = None
    ds = SyntheticSegmentation(n_cls, size=size, length=2, seed=seed)
    x = torch.from_numpy(np.stack([ds[i][0] for i in range(2)]))
    home = next(model.parameters()).device
    model = model.to("cuda").train()
    with torch.no_grad():
        model(x.float().cuda().permute(0, 3, 1, 2))
    for bn in bns:
        bn.momentum = 0.1
    return model.to(home).eval()


@contextlib.contextmanager
def calibrated_teacher_builds(teacher=TEACHER, skip=0, size=CROP,
                              n_cls=N_CLS):
    """While active, build_model gives the teacher calibrated BN
    statistics (calibrate_bn at `size`²): every build of `teacher` after
    the first `skip` (main builds the student first, so a student of the
    teacher's architecture is skipped); every other model is built
    unchanged."""
    import kd_cheap_conv_tpu_torch.models as models

    orig = models.build_model
    seen = {"builds": 0}

    def build(name, *args, **kw):
        m = orig(name, *args, **kw)
        if name != teacher:
            return m
        seen["builds"] += 1
        if seen["builds"] <= skip:
            return m
        return calibrate_bn(m, seed=7, size=size, n_cls=n_cls)

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


def run_main(extra, base=MAIN_ARGS):
    from kd_cheap_conv_tpu_torch import main as port_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_main.main(base + extra)
    torch.cuda.synchronize()
    text = out.getvalue()
    sys.stdout.write(text)
    if rc != 0:
        raise SystemExit(f"main returned {rc}")
    miou = float(text.split("Mean IoU:")[1].split()[0])
    if not math.isfinite(miou):
        raise SystemExit(f"main: Mean IoU is {miou}")
    return miou


def loss_inputs(dtype, g, geo=LOSS_GEO):
    """The loss inputs at geometry geo (LOSS_GEO's form): head-resolution
    student logits ~N(0, 4), a teacher spanning +-1e5 (so the 3e4 clip
    binds), int64 labels at the output size with ~5% void."""
    shape = geo["shape"]
    n, n_cls, out = shape[0], shape[1], geo["args"][:2]
    s = (2.0 * torch.randn(shape, device="cuda", generator=g)).to(dtype)
    t = (1e5 * (2 * torch.rand(shape, device="cuda", generator=g) - 1)
         ).to(dtype)
    lbl = torch.randint(0, n_cls, (n, *out), device="cuda", generator=g)
    void = torch.rand((n, *out), device="cuda", generator=g) < 0.05
    return s, t, lbl.masked_fill(void, 255)


def loss_parity(g, worst, geo=LOSS_GEO):
    """Phase loss_parity: kernels C and D against their plain versions in
    f64 at geometry geo, KL and CE-only instances, f32 and bf16 logits,
    within LOSS_TOL; C's sums and D's ds of a second call bit for bit."""
    from kd_cheap_conv_tpu_torch.ops import losses_fused as lf

    loss_args = geo["args"]
    for dtype in (torch.float32, torch.bfloat16):
        s, t, lbl = loss_inputs(dtype, g, geo)
        scales = loss_scales(lbl, loss_args[2])
        for with_kl in (True, False):
            tt = t if with_kl else None
            t64 = t.double() if with_kl else None
            got = lf.ce_kl_upsampled_fwd(s, tt, lbl, *loss_args)
            sums_twice = bool(torch.equal(got, lf.ce_kl_upsampled_fwd(
                s, tt, lbl, *loss_args)))
            want = lf.ce_kl_upsampled_fwd_ref(s.double(), t64, lbl,
                                              *loss_args)
            ds = lf.ce_kl_upsampled_bwd(s, tt, lbl, scales, *loss_args)
            twice = bool(torch.equal(ds, lf.ce_kl_upsampled_bwd(
                s, tt, lbl, scales, *loss_args)))
            ds_ref = lf.ce_kl_upsampled_bwd_ref(
                s.double(), t64, lbl, scales.double(), *loss_args).to(dtype)
            torch.cuda.synchronize()
            verr = float(((got - want).abs() / want.abs().clamp_min(1.0))
                         .max())
            derr = (ds.float() - ds_ref.float()).abs()
            ok = (verr <= LOSS_TOL["values"] and twice and sums_twice
                  and bool((derr <= LOSS_TOL["ds_atol"] + LOSS_TOL["ds_rtol"]
                            * ds_ref.float().abs()).all()))
            npix = lbl.numel()
            t2 = loss_args[2] ** 2
            losses_k = [got[0] / got[1].clamp_min(1), t2 * got[2] / npix]
            losses_p = [want[0] / want[1].clamp_min(1), t2 * want[2] / npix]
            worst["C", dtype] = max(worst["C", dtype], *(
                float((a - b).abs()) for a, b in zip(losses_k, losses_p)))
            worst["D", dtype] = max(worst["D", dtype], float(derr.max()))
            phase("loss_parity", at=geo["at"],
                  instance="kl" if with_kl else "ce", dtype=str(dtype)[6:],
                  shape=list(s.shape), out=list(loss_args[:2]),
                  sums=got.tolist(), sums_plain=want.tolist(),
                  values_rel_err=verr, ds_max_abs_err=float(derr.max()),
                  ds_max_abs=float(ds_ref.float().abs().max()),
                  ds_bit_identical_twice=twice,
                  sums_bit_identical_twice=sums_twice, tol=LOSS_TOL, ok=ok)
            if not ok:
                raise SystemExit(f"loss parity failed ({geo['at']}, {dtype}, "
                                 f"{'kl' if with_kl else 'ce'})")
        del s, t, lbl, ds, ds_ref


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
    if any(v[1] in name for v in XEVAL.values()):
        return "xeval"
    if BNECK[0] in name:
        return "teacher_chain"
    if any(v[0] in name for v in FULL_LOSS.values()):
        return "loss_full"
    if any(v in name for v in LOSS_KERNELS.values()):
        return "loss_CD"
    if any(v[0] in name for v in RESAMPLE_KERNELS.values()):
        return "resample_dw"
    if any(v[0] in name for v in HEAD_KERNELS.values()):
        return "head"
    if any(v[1] in name for v in X_PASSES.values() if v[3] == XPW_SRC):
        return "wide_pw"
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
    want[BNECK[0]] = BNECK[1]
    for table in (PASSES, ENTRY, HEAD_KERNELS, RESAMPLE_KERNELS):
        for name, per_step, _ in table.values():
            want[name] = want.get(name, 0) + per_step
    return {k: v for k, v in want.items() if v}


def device_split(fn, want, rounds=3, head=None):
    """Device ms of one call of fn by kernel class (torch.profiler), the
    largest kernels of the 'other' class as (name, ms, calls), and the
    number of profiled rounds it took. Each round records the second of two
    calls (the first is the profiler's warm-up). A round counts only if the
    profile holds every kernel function of `want` ({name: launches}) as
    often as fn launches it: a profile can lose a kernel's device events,
    and then its class would read low. Raises if no round of `rounds`
    does. Where `head` is a dict, it receives the head class by kernel
    (HEAD_KERNELS' keys: ms of that kernel function in the counted
    round)."""
    seen = []
    for attempt in range(1, rounds + 1):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        split = {"loss_CD": 0.0, "loss_full": 0.0, "teacher_chain": 0.0,
                 "xeval": 0.0, "wide_pw": 0.0, "bn_passes": 0.0,
                 "entry": 0.0, "head": 0.0, "resample_dw": 0.0, "convs": 0.0,
                 "bn": 0.0, "other": 0.0}
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
            if head is not None:
                head.clear()
                head.update({k: round(sum(
                    e.device_time_total / 1e3 for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and re.search(
                        rf"(?<!\w){v[0]}(?!\w)", e.key)), 4)
                    for k, v in HEAD_KERNELS.items()})
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
    """Phase chain_parity, kernel by kernel: every geometry, f32 and bf16,
    within PASS_TOL; every output twice, bit for bit (the forward's mean
    and variance, the backward's sums and weight gradients included)."""
    fwd, bwd = pass_geometries()
    for dtype in (torch.float32, torch.bfloat16):
        for geo in fwd + bwd:
            kind = geo[1]
            kernel, plain = pass_fns(kind)
            args = pass_args(geo, dtype, g)
            got, again, want = kernel(*args), kernel(*args), plain(*args)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) for a, b in zip(got, want)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = same and all(r <= PASS_TOL[dtype] for r, _ in errs)
            worst[kind, dtype] = max(worst.get((kind, dtype), 0.0),
                                     errs[0][1])
            phase("chain_parity", kernel=kind, at=geo[0],
                  shape=list(geo[2]), co=geo[3], dtype=str(dtype)[6:],
                  rel_errs=[r for r, _ in errs],
                  max_abs_errs=[d for _, d in errs],
                  twice_bit_identical=same, tol=PASS_TOL[dtype], ok=ok)
            if not ok:
                raise SystemExit(f"chain parity failed: {kind} at {geo[0]} "
                                 f"{dtype}")
            del got, again, want, args


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

    res = {"values": max(l2(a, c) / float(c.detach().norm())
                         for a, c in ((out, w64["out"]),
                                      (low, w64["low_level"]))),
           "values_modules": max(l2(b, c) / float(c.detach().norm())
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


def stem_f64(x, stem):
    """The teacher stem in f64 from the bf16 kernel's own operands: the bf16
    image and the bf16 folded weight widened to f64, conv + shift + relu +
    max pool (NHWC); and, over each pool window, the largest sum of |x w| +
    |shift| (the scale of an f32 sum's rounding error)."""
    import torch.nn.functional as F

    from kd_cheap_conv_tpu_torch.ops import tstem as tts

    w, shift = tts.fold_stem(stem.conv, stem.bn, torch.bfloat16)
    wk = w.double().reshape(64, 7, 7, 3).permute(0, 3, 1, 2)
    xc = x.double().permute(0, 3, 1, 2)
    h = torch.relu(F.conv2d(xc, wk, None, 2, 3)
                   + shift.double()[:, None, None])
    s = (F.conv2d(xc.abs(), wk.abs(), None, 2, 3)
         + shift.double().abs()[:, None, None])
    return tuple(F.max_pool2d(t, 3, 2, 1).permute(0, 2, 3, 1) for t in (h, s))


def ulp_miss(got, want, scale):
    """got against the f64 want, one bf16 ulp of each output's own magnitude
    plus the bound of the f32 sum's own error (148 terms, 2^-23 of `scale`
    each: an output at relu's edge keeps an f32 sum's error, which no f32
    kernel avoids): (outputs beyond it, outputs beyond one ulp alone, the
    largest error in ulps of the outputs above 2^-7)."""
    a = want.abs()
    ulp = torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a)) - 7),
                      torch.zeros_like(a))
    err = (got.double() - want).abs()
    big = a >= 2.0 ** -7
    return (int((err > ulp + 148 * 2.0 ** -23 * scale).sum()),
            int((err > ulp).sum()),
            float((err[big] / ulp[big]).max()) if bool(big.any()) else 0.0)


def entry_parity(g, worst):
    """Phase entry_parity, kernel by kernel: the four entry kernels at
    config #2's shapes, f32 and bf16, against their plain versions (the f0
    kernels to PASS_TOL relative to the largest value, the stem to TOL per
    element; the bf16 stem also to one bf16 ulp of each output's own
    magnitude, plus the f32 sum's error bound, against an f64 run of its
    operands, `stem_f64`, `ulp_miss`); the weight
    gradient twice, bit for bit; the image gradient again at an odd-by-even
    size."""
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
                ulp = None
                if k == "tstem":
                    rtol, atol = TOL[dtype]
                    a, b = got[0].float(), want[0].float()
                    ok = bool(((a - b).abs() <= atol + rtol * b.abs()).all())
                    tol = [rtol, atol]
                    if dtype == torch.bfloat16:
                        miss, strict, most = ulp_miss(
                            got[0], *stem_f64(args[0], stem))
                        ulp = {"beyond_tol": miss, "beyond_one_ulp": strict,
                               "max_ulps_above_2^-7": most}
                        ok = ok and miss == 0
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
                      vs_f64=ulp, ok=ok and twice)
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


def host_us(fn, calls=200, rounds=3):
    """Host microseconds per call of fn: the CPU wall time of `calls`
    back-to-back calls on ready inputs, without synchronising, over
    `calls` (what a wrapper adds to the host's side of a step); the median
    of `rounds` such runs."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


# the narrow 1x1 pass kernels whose pass_time rows also time the stock
# sequence and the products (pass_stock), and the redesigned wrappers whose
# rows give their host time per call
PASS_STOCK = ("bn_pw", "pw_bwd")
PASS_HOST = ("bn_pw", "pw_bwd", "bn_dw", "bn_dw_s2")


def pass_stock(geo, args):
    """(the stock sequence a narrow 1x1 pass replaces, the torch.matmul
    products alone) on its args, bf16, channels_last: forward, the input
    BN in train mode, the activation and the 1x1 conv (cuDNN); backward,
    autograd through that sequence for the input, weight and BN-affine
    gradients. The products: x . W^T forward; ga . W and ga^T . z
    backward (ga = gy, z = x: the operands' shapes)."""
    import torch.nn.functional as F

    kind, shape, co, relu, has_bn = geo[1:6]
    ci = shape[-1]
    bwd = kind == "pw_bwd"
    x, wk = (args[2], args[5]) if bwd else (args[0], args[2])
    xn = x.permute(0, 3, 1, 2).detach()
    wt = wk.reshape(co, ci, 1, 1)
    gam = torch.ones(ci, device="cuda", requires_grad=True)
    bet = torch.zeros(ci, device="cuda", requires_grad=True)

    def seq(xin, wgt):
        u = (F.batch_norm(xin, None, None, gam, bet, True, 0.0, 1e-5)
             if has_bn else xin)
        u = (F.hardtanh(u, 0.0, 6.0) if relu is True
             else F.relu(u) if relu == "relu" else u)
        return F.conv2d(u, wgt)

    if not bwd:
        return (lambda: seq(xn, wt)), (
            lambda: torch.matmul(x.reshape(-1, ci), wk.t()))
    xr = xn.detach().requires_grad_()
    wr = wt.detach().requires_grad_()
    y = seq(xr, wr)
    gy = args[0].permute(0, 3, 1, 2)
    want = (xr, wr, gam, bet) if has_bn else (xr, wr)
    ga, zz = args[0].reshape(-1, co), x.reshape(-1, ci)

    def stock():
        return torch.autograd.grad(y, want, gy, retain_graph=True)

    def lib():
        return torch.matmul(ga, wk), torch.matmul(ga.t(), zz)
    return stock, lib


def pass_times(g, total, bound, stock, product, card):
    """Phase pass_time: each pass kernel at each of its geometries against
    its plain version, bf16 (device time of all the wrapper launches: the
    kernel and its partial-sum reduction). The narrow 1x1 kernels
    (PASS_STOCK) also against the stock sequence they replace and the
    torch.matmul products alone (stock_ms, product_ms), and the redesigned
    wrappers (PASS_HOST: the narrow 1x1 forward and backward, the
    depthwise forward) with
    their host time per call (host_us). Each line is one geometry, called
    once per step (per_step_calls). Accumulates per-step sums; phase
    pass_step sums the PASS_STOCK rows over the step."""
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
        extra = {}
        if kind in PASS_STOCK:
            seq, lib = pass_stock(geo, args)
            t_stock, t_lib = device_ms_all(seq), device_ms_all(lib)
            stock[kind] = stock.get(kind, 0.0) + t_stock
            product[kind] = product.get(kind, 0.0) + t_lib
            extra.update(stock_ms=round(t_stock, 4), product_ms=round(t_lib, 4))
            del seq, lib
        if kind in PASS_HOST:
            extra["host_us"] = round(host_us(lambda: kernel(*args)), 2)
        phase("pass_time", kernel=kind, at=geo[0], shape=list(geo[2]),
              co=geo[3], dtype="bfloat16", ms=round(t_ker, 4),
              plain_ms=round(t_ref, 4),
              bound_ms=round(max(b_bytes, b_ops), 5),
              bound_by="bytes" if b_bytes >= b_ops else "operations",
              per_step_calls=1, **extra, card=card)
        del args
    for kind in PASS_STOCK:
        phase("pass_step", kernel=kind, per_step_launches=PASSES[kind][1],
              ms=round(total[kind, torch.bfloat16][0], 4),
              plain_ms=round(total[kind, torch.bfloat16][1], 4),
              stock_ms=round(stock[kind], 4),
              product_ms=round(product[kind], 4),
              bound_ms=round(bound[kind][0], 5), card=card)


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


def head_inputs(dtype, g, geo=HEAD_GEO):
    """Seeded inputs of the head kernels at geometry geo (HEAD_GEO's form;
    at config #2: low (16, 129, 129, 48), up (.., 256)) ~N(0, 1) in `dtype`;
    the separable conv's arguments by dilation ("sep", from geo["sep"]: at
    config #2 the ASPP branches 16 x 33² x 320 -> 256 at 6, 12 and 18 and,
    at 1, the serving decoder's fuse conv, 4 x 129² x 304 -> 256); a and its
    batch moments from the plain P1; weights scaled by fan-in (1x1 weights
    in `dtype`, depthwise taps f32); BN packs with those moments and
    plausible affine parameters and sums; the cotangents g (logits) and gu
    ~N(0, 1)."""
    from kd_cheap_conv_tpu_torch.ops import decoder as tdec
    from kd_cheap_conv_tpu_torch.ops import stem as tst

    def randn(*s, scale=1.0):
        return scale * torch.randn(s, device="cuda", generator=g)

    n, (hh, hw), cm = geo["n"], geo["hw"], geo["cm"]
    ci = geo["cl"] + geo["cu"]
    d = {"low": randn(n, hh, hw, geo["cl"]).to(dtype),
         "up": randn(n, hh, hw, geo["cu"]).to(dtype),
         "k": randn(ci, 9, scale=1 / 3),
         "pw": randn(cm, ci, scale=ci ** -0.5).to(dtype),
         "wc": randn(geo["ncls"], cm, scale=cm ** -0.5).to(dtype),
         "bc": randn(geo["ncls"], scale=0.1),
         "sep": {}, "sep_geo": {}}
    shared = {}                    # the ASPP branches share x and pw
    for dil, (shape, co) in geo["sep"].items():
        c = shape[-1]
        if shape not in shared:
            shared[shape] = (randn(*shape).to(dtype),
                             randn(co, c, 1, 1, scale=c ** -0.5).to(dtype))
        x, pws = shared[shape]
        d["sep"][dil] = (x, randn(c, 1, 3, 3, scale=1 / 3).to(dtype), pws,
                         dil)
        d["sep_geo"][dil] = (tuple(shape), co)
    with torch.no_grad():
        a, sums = tdec.sep_fwd_ref(d["low"], d["up"], d["k"], d["pw"])
    mean, var = tst._moments(sums, tst._count(a))
    m = tst._count(a)
    gam = 1 + randn(cm, scale=0.2)
    d.update(a=a, bn=tst._bn_pack(mean, var, gam, randn(cm, scale=0.1)),
             pn=torch.stack([mean, var, gam, randn(cm, scale=m ** 0.5),
                             randn(cm, scale=m ** 0.5),
                             torch.full((cm,), 1.0 / m, device="cuda")], 1),
             gl=randn(n, hh, hw, geo["ncls"]).to(dtype),
             gu=randn(n, hh, hw, cm).to(dtype))
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


def head_bound_ms(k, n=TRAIN_BATCH, esize=2, hw=(HEAD, HEAD), ncls=N_CLS,
                  sep=((TRAIN_BATCH, ASPP_HW, ASPP_HW, ASPP_C), CM)):
    """Least time of head kernel k on the card, as (bytes ms, FLOP ms):
    each activation read or written once in bf16, the weights once; the
    FLOPs of its products and depthwise taps over the bf16 tensor-core
    peak; the decoder's passes on n x hw pixels and ncls classes. "sep" is
    one separable conv of geometry sep (input NHWC, Co; by default a
    config-#2 ASPP branch)."""
    ci = CL + CU
    p = n * hw[0] * hw[1]
    wts = (CM * ci + ncls * CM) * esize + ci * 9 * 4
    if k == "sep":
        (sn, sh, sw, sc), co = sep
        q = sn * sh * sw
        nbytes = q * (sc + co) * esize + sc * (co * esize + 36)
        flops = 2 * q * sc * (9 + co)
    elif k == "sep_fwd":
        nbytes = p * (ci + CM) * esize + wts
        flops = 2 * p * ci * (9 + CM)
    elif k == "head_fwd":
        nbytes = p * (CM + ncls) * esize + wts
        flops = 2 * p * CM * ncls
    elif k == "head_bwd":
        nbytes = p * (ncls + 2 * CM) * esize + wts
        flops = 4 * p * CM * ncls
    else:
        nbytes = p * (2 * CM + 2 * ci) * esize + wts
        flops = 4 * p * ci * CM + 3 * 18 * p * ci
    return nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3


def head_parity(g, worst, geo=HEAD_GEO, only=None):
    """Phase head_parity, kernel by kernel: the five head kernels (those of
    `only`, where given) at geometry geo (config #2's by default, config
    #3's read from its step),
    f32 and bf16, against their plain versions (the separable conv at each
    of geo's separable convs); the weight gradients (dWc, dbc, dpw, dk) of a
    second run bit for bit."""
    for dtype in (torch.float32, torch.bfloat16):
        d = head_inputs(dtype, g, geo)
        for k in only or HEAD_KERNELS:
            for dil in (d["sep"] if k == "sep" else (None,)):
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
                phase("head_parity", at=geo["at"], kernel=k, dilation=dil,
                      shape=list(got[0].shape),
                      dtype=str(dtype)[6:], outputs=list(kinds),
                      rel_errs=[r for r, _ in errs],
                      max_abs_errs=[e for _, e in errs], tol=tols,
                      weights_twice_bit_identical=twice, ok=ok and twice)
                if not (ok and twice):
                    raise SystemExit(f"head parity failed: {geo['at']} {k} "
                                     f"{dil} {dtype}")
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


def head_times(g, total, bound, stock, card, x_head=None):
    """Phase head_time: each head kernel at config #2's shapes in bf16 and
    its bound. The separable conv ("sep", summed over the three ASPP
    branches: a KD step's launches; the serving decoder's fuse conv in a
    row of its own) and P1 ("sep_fwd"), one launch a call, are timed by
    CUDA events in turns with their plain versions (`ms`, `plain_ms`), the
    profiler's reading beside them (`profiled_ms`, `profiled_plain_ms`);
    the others by torch.profiler (the device time of the wrapper's
    kernels, of its plain version). Each also against the stock sequence
    it replaces (torch.profiler); the wrappers of "sep", P1, B1 and B2 with
    their host time per call (host_us). Where x_head (config #3's head
    geometry, HEAD_GEO's form) is given, "sep" (its three 2048-wide
    branches), P1, B1 and B2 again at that geometry. Then the whole head
    forward + backward (bf16, batch 16) through the kernels against the
    module path with stock convs and upsample, in turns (CUDA events)."""
    def kernel_rows(geo, d, kinds, serving):
        for k in kinds:
            t_ker = t_ref = p_ker = p_ref = t_stock = b_bytes = b_ops = 0.0
            host = 0.0
            events = k in ("sep", "sep_fwd")
            dils = [dl for dl in d["sep"] if dl != 1] if k == "sep" else [None]
            for dil in dils:
                kernel, plain, _ = head_fns(k, d, dil)
                with torch.no_grad():
                    if events:
                        tk, tp = paired_ms(kernel, plain)
                        t_ker, t_ref = t_ker + tk, t_ref + tp
                    pk, pp = device_ms_all(kernel), device_ms_all(plain)
                    p_ker, p_ref = p_ker + pk, p_ref + pp
                    if k in ("sep", "sep_fwd", "head_bwd", "sep_bwd"):
                        host += host_us(kernel) / len(dils)
                t_stock += device_ms_all(head_stock(k, d, dil))
                bb, bo = head_bound_ms(k, geo["n"], hw=geo["hw"],
                                       ncls=geo["ncls"],
                                       **({"sep": d["sep_geo"][dil]}
                                          if k == "sep" else {}))
                b_bytes, b_ops = b_bytes + bb, b_ops + bo
            if not events:
                t_ker, t_ref = p_ker, p_ref
            if geo is HEAD_GEO:
                total[k, torch.bfloat16] = (t_ker, t_ref)
                bound[k] = [max(b_bytes, b_ops), b_bytes, b_ops]
                stock[k] = t_stock
            extra = {"profiled_ms": round(p_ker, 4),
                     "profiled_plain_ms": round(p_ref, 4)} if events else {}
            if k in ("sep", "sep_fwd", "head_bwd", "sep_bwd"):
                extra["host_us"] = round(host, 2)
            if k == "sep":
                extra["dilations"] = dils
            phase("head_time", at=geo["at"], kernel=k, dtype="bfloat16",
                  shape=([list(d["sep_geo"][dils[0]][0]),
                          d["sep_geo"][dils[0]][1]] if k == "sep" else
                         [geo["n"], *geo["hw"], geo["cl"] + geo["cu"]]),
                  ms=round(t_ker, 4), plain_ms=round(t_ref, 4),
                  stock_ms=round(t_stock, 4),
                  bound_ms=round(max(b_bytes, b_ops), 5),
                  bound_by="bytes" if b_bytes >= b_ops else "operations",
                  per_step_launches=len(dils) if k == "sep" else 1,
                  **extra, card=card)
        if serving and 1 in d["sep"]:    # the serving decoder's fuse conv
            kernel, plain, _ = head_fns("sep", d, 1)
            with torch.no_grad():
                tk, tp = paired_ms(kernel, plain)
                pk = device_ms_all(kernel)
                h_us = host_us(kernel)
            bb, bo = head_bound_ms("sep", sep=d["sep_geo"][1])
            phase("head_time", at=geo["at"], kernel="sep",
                  what="the serving decoder's fuse conv", dilations=[1],
                  shape=[list(d["sep_geo"][1][0]), d["sep_geo"][1][1]],
                  dtype="bfloat16", ms=round(tk, 4), plain_ms=round(tp, 4),
                  profiled_ms=round(pk, 4), bound_ms=round(max(bb, bo), 5),
                  bound_by="bytes" if bb >= bo else "operations",
                  host_us=round(h_us, 2), per_forward_launches=1, card=card)

    d = head_inputs(torch.bfloat16, g)
    kernel_rows(HEAD_GEO, d, HEAD_KERNELS, True)
    del d
    if x_head is not None:
        d = head_inputs(torch.bfloat16, g, x_head)
        kernel_rows(x_head, d, ("sep", "sep_fwd", "head_bwd", "sep_bwd"), False)
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


# the decoder upsample at config #2: (label, input NHWC, output size), the
# KD step's at batch 16 and serving's at batch 4
UP_GEO = [(f"b{n}", (n, ASPP_HW, ASPP_HW, CU), (HEAD, HEAD))
          for n in (TRAIN_BATCH, BATCH)]


def resample_inputs(dtype, g, geos, ups=UP_GEO):
    """Seeded inputs of the upsample and depthwise kernels at the step's
    shapes: [(kernel, label, a, b, k, dilation, weight (C, 1, k, k) for the
    library call)]: the upsample forward and backward at each geometry of
    `ups`, the depthwise at every geometry of `geos` (in `dtype`, whatever
    the step's); activations ~N(0, 1), taps ~N(0, 1/9) rounded to
    `dtype`."""
    def randn(*s, scale=1.0):
        return scale * torch.randn(s, device="cuda", generator=g)

    out = []
    for label, shape, size in ups:
        n, h, w, c = shape
        x = randn(*shape).to(dtype)
        gy = randn(n, *size, c).to(dtype)
        out.append(("up_fwd", label, x, size, None, None, None))
        out.append(("up_bwd", label, gy, (h, w), None, None, None))
    for label, shape, kk, dil, _ in geos:
        x, gg = randn(*shape).to(dtype), randn(*shape).to(dtype)
        w = randn(shape[-1], 1, kk, kk, scale=1 / kk).to(dtype)
        taps = w.float().reshape(shape[-1], kk * kk).t().contiguous()
        out += [("dw_conv", label, x, taps, kk, dil, w),
                ("dw_dx", label, gg, taps, kk, dil, w),
                ("dw_dk", label, x, gg, kk, dil, w)]
    return out


def resample_dw_parity(g, worst, geos, ups=UP_GEO):
    """Phase resample_dw_parity: the upsample kernels at each geometry of
    `ups` (config #2: 16 and 4 x 33² x 256 -> 129²), and the depthwise conv,
    dx and dk at each geometry of `geos` (config #2: the step's 13), f32
    (TF32 off) and bf16, against their plain versions: f32 max abs error
    RESAMPLE_TOL of the largest plain magnitude, bf16 one ulp of it (dk
    compared after the rounding to bf16 the step gives it); dk twice, bit
    for bit."""
    for dtype in (torch.float32, torch.bfloat16):
        for k, label, a, b, kk, dil, _ in resample_inputs(dtype, g, geos,
                                                          ups):
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


def resample_dw_times(g, geos, total, bound, stock, library, card,
                      x_geos=()):
    """Phase resample_dw_time: each upsample and depthwise kernel summed over
    its launches in one KD step (up_fwd twice at batch 16, up_bwd once, the
    depthwise at the step's 13 geometries in the step's dtypes: bf16 for
    features[8..17], f32 for the ASPP recompute): the device time of its
    wrapper, of its plain version and of the one PyTorch call computing its
    function (torch.profiler), which is also the stock call the step ran
    before (stock_ms = library_ms), and its bound; then the weight gradient
    summed over `x_geos` (config #3's three ASPP recomputes, f32), a row of
    its own beside the config-#2 one."""
    if x_geos:
        sums, each = [0.0] * 5, []
        for label, shape, kk, dil, dt in x_geos:
            x, gg = (torch.randn(shape, device="cuda", generator=g).to(dt)
                     for _ in range(2))
            w = (torch.randn((shape[-1], 1, kk, kk), device="cuda",
                             generator=g) / kk).to(dt)
            kernel, plain = resample_fns("dw_dk", x, gg, kk, dil)
            with torch.no_grad():
                t = [device_ms_all(kernel), device_ms_all(plain),
                     device_ms_all(resample_library("dw_dk", x, gg, kk, dil,
                                                    w))]
            t += resample_bound_ms("dw_dk", shape, kk, dil,
                                   esize=x.element_size())
            sums = [a + b for a, b in zip(sums, t)]
            each.append([label, list(shape), str(dt)[6:], round(t[0], 4)])
            del x, gg
        t_ker, t_ref, t_lib, bb, bo = sums
        phase("resample_dw_time", kernel="dw_dk", at="config #3",
              ms=round(t_ker, 4), plain_ms=round(t_ref, 4),
              library_ms=round(t_lib, 4), bound_ms=round(max(bb, bo), 5),
              bound_by="bytes" if bb >= bo else "operations",
              per_step_launches=len(x_geos), each=each, card=card)
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


def stock_teacher(model):
    """The teacher with its stem, bottleneck and upsample kernels turned off
    on its instances: every block runs its modules (cuDNN convs, eval BN,
    relu, add), the stem its conv and max_pool2d, the decoder F.interpolate.
    `unstock_teacher` turns them back on."""
    from kd_cheap_conv_tpu_torch.models.deeplab import DeepLabHeadV3Plus

    model.backbone._fused_stem_eval_active = lambda: False
    model.backbone._bneck_eval_active = lambda blk: False
    for m in model.modules():
        if isinstance(m, DeepLabHeadV3Plus):
            m.upsample_active = lambda x, size: False
    return model


def unstock_teacher(model):
    from kd_cheap_conv_tpu_torch.models.deeplab import DeepLabHeadV3Plus

    del model.backbone._fused_stem_eval_active
    del model.backbone._bneck_eval_active
    for m in model.modules():
        if isinstance(m, DeepLabHeadV3Plus):
            del m.upsample_active
    return model


@contextlib.contextmanager
def recorded_bnecks(out):
    """While active, every bottleneck the teacher's forward hands to the
    kernel is appended to `out` as (input NHWC shape, block)."""
    import kd_cheap_conv_tpu_torch.models.resnet as tres

    orig = tres.run_bneck_eval

    def run(x, blk):
        out.append((tuple(x.shape), blk))
        return orig(x, blk)

    tres.run_bneck_eval = run
    try:
        yield out
    finally:
        tres.run_bneck_eval = orig


def train_images(n=TRAIN_BATCH, seed=1):
    from kd_cheap_conv_tpu_torch.data import SyntheticSegmentation

    ds = SyntheticSegmentation(N_CLS, size=CROP, length=n, seed=seed)
    im, lb = zip(*(ds[i] for i in range(n)))
    return (torch.from_numpy(np.stack(im)).float().cuda().permute(0, 3, 1, 2),
            torch.from_numpy(np.stack(lb)).long().cuda())


def rchain_bound_ms(shape, blk, esize=2):
    """Least time of one bottleneck on the card, as (bytes ms, FLOP ms): its
    input, output and folded weights read or written once over HBM, its
    products over the bf16 tensor-core peak."""
    n, h, w, c = shape
    cm, co = blk.conv1.out_channels, blk.conv3.out_channels
    ds = blk.downsample is not None
    macs = c * cm + 9 * cm * cm + cm * co + ds * c * co
    nbytes = esize * (n * h * w * (c + co) + macs) + 4 * (2 * cm + co
                                                          + ds * co)
    return nbytes / HBM_BPS * 1e3, 2 * n * h * w * macs / BF16_FLOPS * 1e3


def rchain_parity(worst, launches_of):
    """Phase rchain_parity: the teacher's whole forward (ResNet-101
    DeepLabV3+, f32, calibrated BN statistics, 16 x 513²) through its stem,
    bottleneck and upsample kernels and through its module path, in f32
    with TF32 off, both held to the module path in f64 (TEACHER_TOL) on the
    logits and both backbone taps, with 6 bottleneck launches. Then the
    bottleneck kernel against its plain version at the six block geometries
    that forward gave it, f32 and bf16, run twice, bit for bit."""
    from kd_cheap_conv_tpu_torch.models import build_model
    from kd_cheap_conv_tpu_torch.ops import rchain as trc

    teacher = calibrate_bn(build_model(
        TEACHER, N_CLS, 16, generator=torch.Generator().manual_seed(2)),
        seed=7).to("cuda", memory_format=torch.channels_last).eval()
    x, _ = train_images()
    geos = []
    before = launches_of()
    with torch.no_grad(), recorded_bnecks(geos):
        logits, feats = teacher(x, return_features=True)
    got = {k: v - before[k] for k, v in launches_of().items()}
    with torch.no_grad():
        mod, mod_f = stock_teacher(teacher)(x, return_features=True)
        t64 = copy.deepcopy(teacher).double()
        ref, ref_f = t64(x.double(), return_features=True)
    unstock_teacher(teacher)
    del t64
    torch.cuda.synchronize()
    errs, ok = {}, True
    for k, a, m, r in (("logits", logits, mod, ref),
                       ("low_level", feats["low_level"], mod_f["low_level"],
                        ref_f["low_level"]),
                       ("out", feats["out"], mod_f["out"], ref_f["out"])):
        top = float(r.abs().max())
        e_k = float((a.double() - r).abs().max()) / top
        e_m = float((m.double() - r).abs().max()) / top
        errs[k] = {"kernels_vs_f64": e_k, "modules_vs_f64": e_m}
        ok = ok and e_k <= max(TEACHER_TOL["floor"],
                               TEACHER_TOL["vs_noise"] * e_m)
    ok = (ok and got["bneck"] == 6 and got["tstem"] == 1
          and got["up_fwd"] == 1 and bool(torch.isfinite(logits).all()))
    phase("rchain_parity", what="teacher forward, f32, 16 x 513², kernels "
          "and module path vs the f64 module path", rel_err=errs,
          tol=TEACHER_TOL, launches=got,
          max_abs_logit=float(ref.abs().max()), ok=ok)
    if not ok:
        raise SystemExit(f"rchain parity: teacher forward {errs}, launches "
                         f"{got}")
    del logits, feats, mod, mod_f, ref, ref_f
    g = torch.Generator(device="cuda").manual_seed(9)
    for dtype in (torch.float32, torch.bfloat16):
        for i, (shape, blk) in enumerate(geos):
            a = torch.relu(torch.randn(shape, device="cuda",
                                       generator=g)).to(dtype)
            with torch.no_grad():
                y, y2 = trc.run_bneck_eval(a, blk), trc.run_bneck_eval(a, blk)
                ref = trc.bneck_eval_ref(a, blk)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            top = float(ref.float().abs().max())
            same = bool(torch.equal(y, y2))
            ok = err <= RCHAIN_TOL[dtype] * top and same
            worst["bneck", dtype] = max(worst.get(("bneck", dtype), 0.0), err)
            phase("rchain_parity", block=i, shape=list(shape),
                  co=blk.conv3.out_channels,
                  downsample=blk.downsample is not None,
                  dtype=str(dtype)[6:], max_abs_err=err, max_abs=top,
                  rel_err=err / top, tol=RCHAIN_TOL[dtype],
                  bit_identical_twice=same, ok=ok)
            if not ok:
                raise SystemExit(f"rchain parity failed: block {i} {shape} "
                                 f"{dtype}")
    del teacher, x


def cached_loss_inputs(dtype, g):
    """Config #1's loss inputs: full-resolution student logits ~N(0, 4) in
    `dtype`, the teacher as the cache delivers it (float16, NHWC memory,
    an NCHW view) spanning +-6e4 (the 3e4 clip binds), int64 labels with
    ~5% void."""
    n, c = TRAIN_BATCH, N_CLS
    s = (2.0 * torch.randn((n, c, CROP, CROP), device="cuda",
                           generator=g)).to(dtype)
    t = (6e4 * (2 * torch.rand((n, CROP, CROP, c), device="cuda",
                               generator=g) - 1)).half().permute(0, 3, 1, 2)
    lbl = torch.randint(0, c, (n, CROP, CROP), device="cuda", generator=g)
    void = torch.rand((n, CROP, CROP), device="cuda", generator=g) < 0.05
    return s, t, lbl.masked_fill(void, 255)


def edge_labels(lbl, c):
    """lbl with labels outside [0, C) (C + 3 along half of image 0's first
    row), negative ones (-1 along a third of its second row) and, where
    there are two images or more, an all-void last image."""
    lbl = lbl.clone()
    n, h, w = lbl.shape
    lbl[0, 0, :max(1, w // 2)] = c + 3
    lbl[0, min(1, h - 1), :max(1, w // 3)] = -1
    if n > 1:
        lbl[-1] = 255
    return lbl


def cached_loss_parity(g, worst):
    """Phase cached_loss_parity: the full-resolution forward and backward
    kernels against their plain versions at (16, 21, 513, 513), f32 and
    bf16 student logits, the float16 NHWC teacher and its float32
    class-major copy, within LOSS_TOL, then bf16 with the float16 NHWC
    teacher and edge labels (outside [0, C), negative, an all-void image);
    the sums and ds twice, bit for bit."""
    from kd_cheap_conv_tpu_torch.ops import losses_fused as lf

    args = (4.0, 255, 3e4)
    cases = [(dtype, form, False) for dtype in (torch.float32, torch.bfloat16)
             for form in ("f16_nhwc", "f32_nchw")]
    # the edge case draws from its own generator: the other phases' inputs
    # stay as they were
    for dtype, form, edge in cases + [(torch.bfloat16, "f16_nhwc", True)]:
        if form == "f16_nhwc":
            s, t16, lbl = cached_loss_inputs(
                dtype, torch.Generator("cuda").manual_seed(19) if edge else g)
        t = t16 if form == "f16_nhwc" else t16.float().contiguous()
        if edge:
            lbl = edge_labels(lbl, s.shape[1])
        scales = loss_scales(lbl)
        got, got2 = (lf.ce_kl_fwd(s, t, lbl, *args) for _ in range(2))
        want = lf.ce_kl_fwd_ref(s, t, lbl, *args)
        ds, ds2 = (lf.ce_kl_bwd(s, t, lbl, scales, *args) for _ in range(2))
        ds_ref = lf.ce_kl_bwd_ref(s, t, lbl, scales, *args)
        torch.cuda.synchronize()
        verr = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        derr = (ds.float() - ds_ref.float()).abs()
        same = bool(torch.equal(ds, ds2))
        sums_same = bool(torch.equal(got, got2))
        ok = same and sums_same and verr <= LOSS_TOL["values"] and bool(
            (derr <= LOSS_TOL["ds_atol"] + LOSS_TOL["ds_rtol"]
             * ds_ref.float().abs()).all())
        npix = lbl.numel()
        worst["ce_kl_fwd", dtype] = max(
            worst.get(("ce_kl_fwd", dtype), 0.0),
            float((got[0] - want[0]).abs() / want[1].clamp_min(1)),
            float(16.0 * (got[2] - want[2]).abs() / npix))
        worst["ce_kl_bwd", dtype] = max(
            worst.get(("ce_kl_bwd", dtype), 0.0), float(derr.max()))
        phase("cached_loss_parity", dtype=str(dtype)[6:], teacher=form,
              labels="edge" if edge else "random", shape=list(s.shape),
              sums=got.tolist(), sums_plain=want.tolist(),
              values_rel_err=verr, ds_max_abs_err=float(derr.max()),
              ds_max_abs=float(ds_ref.float().abs().max()),
              ds_elements_off_plain=int((ds != ds_ref).sum()),
              sums_bit_identical_twice=sums_same,
              ds_bit_identical_twice=same, tol=LOSS_TOL, ok=ok)
        if not ok:
            raise SystemExit(f"cached loss parity failed ({dtype}, {form}, "
                             f"edge labels {edge})")
        del t, ds, ds2, ds_ref
    del s, t16, lbl


def cached_loss_bound_ms(k, s, t, lbl, sm_clock_mhz, sms):
    """Least time of the full-resolution forward or backward kernel: the
    bytes it must move (s, t and labels read once, ds written once by the
    backward) over HBM against its exponentials (three per class and
    pixel) over the special-function units."""
    nbytes = (s.numel() * s.element_size() + t.numel() * t.element_size()
              + lbl.numel() * lbl.element_size())
    nbytes += s.numel() * s.element_size() if k == "ce_kl_bwd" else 0
    t_bytes = nbytes / HBM_BPS
    t_ops = 3 * s.numel() / (MUFU_PER_CLK_SM * sms * sm_clock_mhz * 1e6)
    return max(t_bytes, t_ops) * 1e3, t_bytes * 1e3, t_ops * 1e3


def cached_loss_times(g, total, bound, stock, sm_clock, sms, card):
    """Phase cached_loss_time: the two full-resolution kernels at config
    #1's step (bf16 s, the float16 NHWC teacher, int64 labels): the time
    of the wrapper and of the plain version by CUDA events, in turns
    (`ms`, `plain_ms`), and by torch.profiler (`profiled_ms`,
    `profiled_plain_ms`); the device time of the stock pair
    F.cross_entropy + F.kl_div (for the backward: its autograd backward,
    the pair's forward + backward less its forward), and the bound."""
    import torch.nn.functional as F

    from kd_cheap_conv_tpu_torch.ops import losses_fused as lf

    args = (4.0, 255, 3e4)
    s, t, lbl = cached_loss_inputs(torch.bfloat16, g)
    scales = loss_scales(lbl)

    def pair(grad):
        sf = s.float().requires_grad_(grad)
        tt = t.float().clamp(-3e4, 3e4)
        loss = 0.5 * F.cross_entropy(sf, lbl, ignore_index=255) + 0.5 * 16.0 \
            * F.kl_div(F.log_softmax(sf / 4.0, 1), F.log_softmax(tt / 4.0, 1),
                       reduction="sum", log_target=True) / lbl.numel()
        if grad:
            loss.backward()
        return loss

    with torch.no_grad():
        fwd_stock = device_ms_all(lambda: pair(False))
    both_stock = device_ms_all(lambda: pair(True))
    fns = {"ce_kl_fwd": (lambda: lf.ce_kl_fwd(s, t, lbl, *args),
                         lambda: lf.ce_kl_fwd_ref(s, t, lbl, *args),
                         fwd_stock),
           "ce_kl_bwd": (lambda: lf.ce_kl_bwd(s, t, lbl, scales, *args),
                         lambda: lf.ce_kl_bwd_ref(s, t, lbl, scales, *args),
                         both_stock - fwd_stock)}
    for k, (kernel, plain, t_stock) in fns.items():
        # each call is one launch: timed by CUDA events in turns with the
        # plain version, because a profile of five such calls can record
        # four of the kernel's launches; the profiler's reading beside it
        t_ker, t_ref = paired_ms(kernel, plain)
        p_ker, p_ref = device_ms_all(kernel), device_ms_all(plain)
        b_ms, b_bytes, b_ops = cached_loss_bound_ms(k, s, t, lbl, sm_clock,
                                                    sms)
        total[k, torch.bfloat16] = (t_ker, t_ref)
        bound[k] = [b_ms, b_bytes, b_ops]
        stock[k] = t_stock
        phase("cached_loss_time", kernel=k, shape=list(s.shape),
              dtype="bfloat16", teacher="float16 NHWC", ms=round(t_ker, 4),
              plain_ms=round(t_ref, 4), profiled_ms=round(p_ker, 4),
              profiled_plain_ms=round(p_ref, 4), stock_ms=round(t_stock, 4),
              bound_ms=round(b_ms, 5),
              bound_by="bytes" if b_bytes >= b_ops else "operations",
              host_us=round(host_us(kernel), 2), sm_clock_max_mhz=sm_clock,
              card=card)
    del s, t, lbl


def rchain_times(teacher, x, total, bound, stock, card):
    """Phase rchain_time: the bottleneck kernel at the six block geometries
    of the KD step's bf16 teacher (read from its forward), per block and
    summed per step: device time of the wrapper, of its plain version and
    of the block's modules (cuDNN convs, eval BN, relu, add: the stock
    sequence), and the bound; and the wrapper's host microseconds per call
    (host_us, the mean over the six blocks)."""
    from kd_cheap_conv_tpu_torch.ops import rchain as trc

    geos = []
    with torch.no_grad(), recorded_bnecks(geos):
        teacher(x, class_major=True, upsample=False)
    g = torch.Generator(device="cuda").manual_seed(10)
    acc, hosts = [0.0] * 5, []
    for i, (shape, blk) in enumerate(geos):
        a = torch.relu(torch.randn(shape, device="cuda",
                                   generator=g)).to(torch.bfloat16)
        a_nchw = a.permute(0, 3, 1, 2)
        with torch.no_grad():
            t_ker = device_ms_all(lambda: trc.run_bneck_eval(a, blk))
            t_ref = device_ms_all(lambda: trc.bneck_eval_ref(a, blk))
            t_stock = device_ms_all(lambda: blk(a_nchw))
            hosts.append(host_us(lambda: trc.run_bneck_eval(a, blk)))
        bb, bo = rchain_bound_ms(shape, blk)
        for j, v in enumerate((t_ker, t_ref, t_stock, bb, bo)):
            acc[j] += v
        phase("rchain_time", block=i, shape=list(shape),
              co=blk.conv3.out_channels, dtype="bfloat16", ms=round(t_ker, 4),
              plain_ms=round(t_ref, 4), stock_ms=round(t_stock, 4),
              bound_ms=round(max(bb, bo), 5),
              bound_by="bytes" if bb >= bo else "operations",
              host_us=round(hosts[-1], 2))
    t_ker, t_ref, t_stock, bb, bo = acc
    total["bneck", torch.bfloat16] = (t_ker, t_ref)
    bound["bneck"] = [max(bb, bo), bb, bo]
    stock["bneck"] = t_stock
    phase("rchain_time", what="the six blocks of one teacher forward",
          ms=round(t_ker, 4), plain_ms=round(t_ref, 4),
          stock_ms=round(t_stock, 4), bound_ms=round(max(bb, bo), 5),
          bound_bytes_ms=round(bb, 5), bound_flops_ms=round(bo, 5),
          bound_by="bytes" if bb >= bo else "operations",
          host_us=round(statistics.mean(hosts), 2), card=card)


def cached_path(kernels, card):
    """Phase cached: config #1 at full width (513², batch 16, bf16) through
    the functions `main --kd --cached_logits` calls, in its order: the
    calibrated bf16 ResNet-101 teacher's logits over a 32-image synthetic
    set into a temporary cache (`precompute_teacher_logits`, batches of
    16), `CachedLogitsDataset`, then the cached step
    (`make_kd_train_step(cached_teacher=True)`) in `train_loop` for 2 steps
    from the loader and device prefetch. Counted from zero around each
    part: per teacher batch 1 teacher-stem, 6 bottleneck and 1 upsample
    launch; per step 1 full-resolution forward and 1 backward, no C, D or
    teacher kernel. Then the cached step's images/s on a device-resident
    batch and its device split (phase cached_rate). Returns the training
    steps' launch counts."""
    from kd_cheap_conv_tpu_torch.data import (SyntheticSegmentation,
                                              make_loader, prefetch_to_device)
    from kd_cheap_conv_tpu_torch.kd.cached import (CachedLogitsDataset,
                                                   precompute_teacher_logits)
    from kd_cheap_conv_tpu_torch.kd.distill import KDConfig
    from kd_cheap_conv_tpu_torch.kd.replace import (CheapConvSpec,
                                                    replace_cheap_convs)
    from kd_cheap_conv_tpu_torch.models import build_model
    from kd_cheap_conv_tpu_torch.models.layers import set_bn_momentum
    from kd_cheap_conv_tpu_torch.train.loop import LoopConfig, train_loop
    from kd_cheap_conv_tpu_torch.train.optim import make_optimizer
    from kd_cheap_conv_tpu_torch.train.steps import (TrainState,
                                                     make_kd_train_step)

    bf16 = torch.bfloat16
    g = torch.Generator().manual_seed(1)
    model = build_model("deeplabv3plus_mobilenet", N_CLS, 16, dtype=bf16,
                        generator=g)
    set_bn_momentum(model.backbone, 0.01)
    teacher = calibrate_bn(build_model(
        TEACHER, N_CLS, 16, dtype=bf16,
        generator=torch.Generator().manual_seed(2)), seed=7)
    replace_cheap_convs(model, CheapConvSpec(), scope="classifier",
                        generator=g)
    teacher = teacher.to("cuda", memory_format=torch.channels_last).eval()
    model = model.to("cuda", memory_format=torch.channels_last)
    ds = SyntheticSegmentation(N_CLS, size=CROP, length=CACHED_IMAGES, seed=1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "teacher_logits.npz")
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        precompute_teacher_logits(teacher, ds, path,
                                  batch_size=TRAIN_BATCH, seed=1)
        build_s = time.perf_counter() - t0
        build = {k: fn.launches for k, fn in kernels.items() if fn.launches}
        del teacher
        cached = CachedLogitsDataset(ds, path)
        opt, sched = make_optimizer(model.named_parameters(), lr=0.01,
                                    max_iters=1000)
        step_fn = make_kd_train_step(model, None, opt, KDConfig(), sched,
                                     cached_teacher=True)
        it = prefetch_to_device(make_loader(
            cached, batch_size=TRAIN_BATCH, shuffle=True, seed=1,
            num_workers=8), "cuda")
        lines = []
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        try:
            train_loop(state=TrainState(model, opt, sched), step_fn=step_fn,
                       train_iter=it, cfg=LoopConfig(
                           total_itrs=2, print_interval=1, val_interval=1000,
                           ckpt_dir=tmp), log_fn=lines.append)
            torch.cuda.synchronize()
        finally:
            it.close()
        train_s = time.perf_counter() - t0
        steps = {k: fn.launches for k, fn in kernels.items() if fn.launches}
        it = prefetch_to_device(make_loader(
            cached, batch_size=TRAIN_BATCH, shuffle=False, num_epochs=1,
            num_workers=8), "cuda")
        batch = next(it)
        it.close()
    losses = [float(ln.split("loss=")[1].split(",")[0])
              for ln in lines if ln.startswith("Itrs")]
    n_batches = CACHED_IMAGES // TRAIN_BATCH
    want_build = {"tstem": n_batches, "bneck": BNECK[1] * n_batches,
                  "up_fwd": n_batches}
    teacher_side = ("tstem", "bneck", "C", "D")
    ok = (len(losses) == 2 and all(map(math.isfinite, losses))
          and build == want_build
          and steps.get("ce_kl_fwd") == 2 and steps.get("ce_kl_bwd") == 2
          and not any(steps.get(k) for k in teacher_side))
    phase("cached", what="config #1: cache build over 32 synthetic 513² "
          "images (teacher batches of 16), then 2 cached KD steps at batch "
          "16, bf16", cache_shape=list(cached.logits.shape),
          cache_dtype=str(cached.logits.dtype), build_s=round(build_s, 2),
          build_launches=build, train_s=round(train_s, 2),
          train_launches=steps, losses=losses, ok=ok)
    if not ok:
        raise SystemExit(f"cached: losses {losses}, cache build launches "
                         f"{build} (want {want_build}), training launches "
                         f"{steps}")
    for _ in range(3):                                        # warm-up
        step_fn(*batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(8):
        t0 = time.perf_counter()
        step_fn(*batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = statistics.quantiles(walls, n=4)
    head = {}
    split, _, rounds = device_split(lambda: step_fn(*batch), {
        v[0]: v[1] for v in FULL_LOSS.values()}, head=head)
    busy = sum(split.values())
    phase("cached_rate", what="cached KD step, 513², batch 16, bf16, "
          "device-resident batch (float16 NHWC teacher logits)",
          steps=len(walls), median_img_per_s=round(TRAIN_BATCH / med * 1e3, 2),
          q1_img_per_s=round(TRAIN_BATCH / q3 * 1e3, 2),
          q3_img_per_s=round(TRAIN_BATCH / q1 * 1e3, 2),
          median_step_ms=round(med, 3),
          device_ms={k: round(v, 3) for k, v in split.items()},
          head_ms_by_kernel=head, device_busy_ms=round(busy, 3),
          device_idle_share=round(1 - busy / med, 3), profiled_rounds=rounds,
          card=card)
    del model, batch, cached
    return steps


# ---------------------------------------------------------------------------
# config #3: the Xception-65 KD step (769², batch 4, 19 classes, bf16), at
# OS16 and at OS8 (the reference's --output_stride 8: the middle flow at
# 97² and dilation 2, the exit flow at dilation 4, ASPP rates 12/24/36)
# ---------------------------------------------------------------------------

X_MODEL = "deeplabv3plus_xception"
X_CROP, X_BATCH, X_CLS, X_STEPS = 769, 4, 19, 4


def x_args(ostride=16):
    """The config-#3 KD command's arguments at output stride `ostride`."""
    return ["--kd", "--dataset", "synthetic", "--model", X_MODEL,
            "--teacher_model", X_MODEL, "--num_classes", str(X_CLS),
            "--replace_scope", "classifier", "--crop_size", str(X_CROP),
            "--batch_size", str(X_BATCH), "--bf16", "--output_stride",
            str(ostride), "--total_itrs", str(X_STEPS), "--val_interval",
            str(X_STEPS), "--print_interval", "2"]


X_ARGS = x_args(16)
XPW_SRC = "kd_cheap_conv_tpu_torch/csrc/wide_pw.cu"
# the pass kernels of the Xception chains: (wrapper in ops.stem, kernel
# function, launches per KD step, source, the TPU kernel it replaces); the
# x_* depthwise rows are bn_passes.cu's kernels on this path. The forward
# rows count the student's train chains (63 / 60 / 3) and the teacher's
# three eval entry blocks (9 / 6 / 3)
X_PASSES = {
    "xpw_fwd": ("run_bn_pw_wide", "xpw_fwd_kernel", 72, XPW_SRC,
                "kd_cheap_conv_tpu/ops/pallas/stem.py:321"),
    "xpw_dgrad": ("run_xpw_dgrad", "xpw_dgrad_kernel", 63, XPW_SRC,
                  "kd_cheap_conv_tpu/ops/pallas/stem.py:776"),
    "xpw_wgrad": ("run_xpw_wgrad", "xpw_wgrad_kernel", 63, XPW_SRC,
                  "kd_cheap_conv_tpu/ops/pallas/stem.py:776"),
    "x_bn_dw": ("run_bn_dw", "bn_dw_fwd_kernel", 66, PASS_SRC,
                "kd_cheap_conv_tpu/ops/pallas/stem.py:302"),
    "x_bn_dw_s2": ("run_bn_dw_s2", "bn_dw_fwd_kernel", 6, PASS_SRC,
                   "kd_cheap_conv_tpu/ops/pallas/stem.py:338"),
    "x_dw_bwd": ("run_dw_bwd", "dw_bwd_kernel", 60, PASS_SRC,
                 "kd_cheap_conv_tpu/ops/pallas/stem.py:824"),
    "x_dw_s2_bwd": ("run_dw_s2_bwd", "dw_bwd_kernel", 3, PASS_SRC,
                    "kd_cheap_conv_tpu/ops/pallas/stem.py:914")}
# the launch counter each row reads
X_COUNTER = {"xpw_fwd": "xpw_fwd", "xpw_dgrad": "xpw_dgrad",
             "xpw_wgrad": "xpw_wgrad", "x_bn_dw": "bn_dw",
             "x_bn_dw_s2": "bn_dw_s2", "x_dw_bwd": "dw_bwd",
             "x_dw_s2_bwd": "dw_s2_bwd"}
# the student's whole f32 backbone (full depth, 4 x 769²) through the chains
# and through its module path, each against the module path in f64 (relative
# L2 per output, max abs over max |f64| per BN statistic): within the floor
# or 3x the f32 module path's own error, whichever is larger; gradients
# within 3x the module path's own error per tensor (train-BN backward is
# ill-conditioned: f32 is held to f64, not to f32)
X_TOL = {"floor": 1e-5, "stats_floor": 1e-4, "vs_noise": 3.0}
X_PARITY_BATCH = 4
XEVAL_SRC = "kd_cheap_conv_tpu_torch/csrc/xchain_eval.cu"
XEVAL_WHERE = ("kd_cheap_conv_tpu/ops/pallas/xchain.py:99 (_k_block_eval), "
               ":746 (_k_seg_eval)")
# the folded sep convs of one eval Xception-65 forward (48 middle flow, 6
# exit flow)
XSEP_CONVS = 54
# the eval chains' folded separable-conv kernels: counter (a wrapper of
# ops.xchain_eval), kernel function, launches per bf16 eval forward. In
# bf16 a sep conv is the depthwise pass and the TMA + wgmma product; the
# f32 kernel (sep_conv.cuh's tile loop) runs only in f32, for parity
XEVAL = {"xsep_dw": ("run_xsep_dw", "xsep_dw_kernel", XSEP_CONVS),
         "xsep_mm": ("run_xsep_mm", "xsep_mm_kernel", XSEP_CONVS),
         "xsep_eval": ("run_xsep_eval", "xsep_eval_kernel", 0)}


def x_entry_chains(ostride=16):
    """The entry blocks that run on the chains, in train and in eval mode:
    all three at OS16; at OS8 block3 has stride 1 and runs on its modules
    (both packages' entry guards take stride 2 only)."""
    return 3 if ostride == 16 else 2


def x_eval_launches(ostride=16, f32=False):
    """Every launch of one eval Xception-65 backbone forward (the config-#3
    teacher's, a serving or validation forward), by counter: the folded sep
    convs and the chained entry blocks' passes (3 wide 1x1, 2 depthwise, 1
    stride-2 depthwise each); in bf16, or in f32."""
    e = x_entry_chains(ostride)
    seps = ({"xsep_eval": XSEP_CONVS} if f32
            else {"xsep_dw": XSEP_CONVS, "xsep_mm": XSEP_CONVS})
    return {**seps, "xpw_fwd": 3 * e, "bn_dw": 2 * e, "bn_dw_s2": e}


def x_train_passes(ostride=16):
    """The pass calls of the student's train chains in one config-#3 KD
    step, by geometry kind: the chained entry blocks' (3 1x1, 2 depthwise, 1
    stride-2 depthwise each), the middle flow's 48 + 48 and the exit flow's
    6 + 6; each forward pass has its backward."""
    e = x_entry_chains(ostride)
    fwd = {"pw": 3 * e + 54, "dw": 2 * e + 54, "dw_s2": e}
    return {**fwd, "pw_bwd": fwd["pw"], "dw_bwd": fwd["dw"],
            "dw_s2_bwd": e}


def x_dw_dilations(ostride=16):
    """The stride-1 depthwise passes of the student's train chains in one
    step by (kind, dilation): the entry blocks at 1, the middle flow at 1
    (OS16) or 2 (OS8), the exit flow at 2 (OS16) or 4 (OS8)."""
    e, mid = x_entry_chains(ostride), 1 if ostride == 16 else 2
    out = {}
    for kind in ("dw", "dw_bwd"):
        for d, n in ((1, 2 * e), (mid, 48), (2 * mid, 6)):
            out[kind, d] = out.get((kind, d), 0) + n
    return out


# the X_PASSES rows whose dilation-4 instance (OS8's exit flow) has a
# kernels-line row of its own, f"{row}_d4", its launches counted apart
# (ops.stem's launches_by_dil)
X_D4 = ("x_bn_dw", "x_dw_bwd")


class DilationCount:
    """The launches of a stride-1 depthwise wrapper's kernel instance at one
    dilation (the wrapper's `launches_by_dil` entry), read and set to zero
    as a wrapper's `launches` are."""

    def __init__(self, fn, dil):
        self.fn, self.dil = fn, dil

    @property
    def launches(self):
        return self.fn.launches_by_dil[self.dil]

    @launches.setter
    def launches(self, value):
        self.fn.launches_by_dil[self.dil] = value


# the eval backbone in f32 against f64: within 2x the f32 module path's own
# error (max abs error over max |f64| per output), or 1e-6 where that is
# smaller
X_EVAL_TOL = {"vs_noise": 2.0, "floor": 1e-6}
X_SERVE_ARGS = ["--test_only", "--dataset", "synthetic", "--model", X_MODEL,
                "--num_classes", str(X_CLS), "--kd", "--replace_scope",
                "classifier", "--crop_size", str(X_CROP), "--val_batch_size",
                str(X_BATCH), "--bf16"]


def x_pass_sig(name, a, kw=None):
    """A pass call's geometry: (kind, input NHWC shape, Co, act, dilation,
    input BN?, next-BN backward?, moments? (False: an eval forward pass))."""
    moments = (kw or {}).get("moments", True)
    if name == "bn_pw":
        return ("pw", tuple(a[0].shape), a[2].shape[0], a[3], 1,
                a[1] is not None, False, moments)
    if name in ("bn_dw", "bn_dw_s2"):
        dil = a[5] if len(a) > 5 else 1
        return (name[3:], tuple(a[0].shape), a[0].shape[-1], a[3], dil,
                a[1] is not None, False, moments)
    if name == "pw_bwd":
        return ("pw_bwd", tuple(a[2].shape), a[0].shape[-1], a[6], 1,
                a[4] is not None, a[3] is not None, True)
    dil = a[8] if len(a) > 8 else 1
    return (name, tuple(a[2].shape), a[2].shape[-1], a[6], dil,
            a[4] is not None, True, True)


@contextlib.contextmanager
def recorded_calls(targets, sig, log):
    """While active, each call of a function that `targets` names [(module,
    attribute)] appends sig(attribute, positional args, keyword args) to
    `log` before it runs. Each is patched where its callers look it up; a wrapper that
    counts its launches through that name then counts them on the patch
    (functools.wraps copies the count), not on the counter main reads."""
    orig = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def wrap(name, fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            log.append(sig(name, a, kw))
            return fn(*a, **kw)
        return run

    for mod, name, fn in orig:
        setattr(mod, name, wrap(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in orig:
            setattr(mod, name, fn)


def x_rest_sig(name, a, kw):
    """A call's geometry, for the kernels of the config-#3 step outside the
    train chains: P1 (low NHWC, Cu, Cm), P2 (classes), the separable conv
    (input NHWC, Co, dilation), the depthwise conv (input NHWC, k,
    dilation, dtype), the upsample (input NHWC, output size), kernel C
    (logits shape, teacher?, the arguments after the labels), the folded
    sep conv (xeval_sig)."""
    if name == "run_xsep_eval":
        return ("xsep", xeval_sig(a, kw))
    if name == "run_sep_fwd":
        return ("head", tuple(a[0].shape), a[1].shape[-1], a[3].shape[0])
    if name == "run_head_fwd":
        return ("classes", a[2].shape[0])
    if name == "run_separable":
        return ("sep", tuple(a[0].shape), a[2].shape[0], a[3])
    if name == "run_dw_conv":
        return ("dw", tuple(a[0].shape), a[2], a[3], a[0].dtype)
    if name == "run_up_fwd":
        return ("up", tuple(a[0].shape), tuple(a[1]))
    return ("loss", tuple(a[0].shape), a[1] is not None, tuple(a[3:]))


def x_batch():
    """The config-#3 synthetic train batch on the card: (images NCHW f32,
    labels)."""
    from kd_cheap_conv_tpu_torch.data import SyntheticSegmentation

    ds = SyntheticSegmentation(X_CLS, size=X_CROP, length=X_BATCH, seed=1)
    im, lb = zip(*(ds[i] for i in range(X_BATCH)))
    return (torch.from_numpy(np.stack(im)).float().cuda().permute(0, 3, 1, 2),
            torch.from_numpy(np.stack(lb)).long().cuda())


def x_student(dtype=torch.bfloat16, seed=1, ostride=16):
    """The config-#3 student as main builds it at output stride `ostride` (bf16
    compute, backbone BN momentum 0.01, head separable-converted), train
    mode, on the card."""
    from kd_cheap_conv_tpu_torch.kd.replace import (CheapConvSpec,
                                                    replace_cheap_convs)
    from kd_cheap_conv_tpu_torch.models import build_model
    from kd_cheap_conv_tpu_torch.models.layers import set_bn_momentum

    g = torch.Generator().manual_seed(seed)
    m = build_model(X_MODEL, X_CLS, ostride, dtype=dtype, generator=g)
    set_bn_momentum(m.backbone, 0.01)
    replace_cheap_convs(m, CheapConvSpec(), scope="classifier", generator=g)
    return m.to("cuda", memory_format=torch.channels_last).train()


def x_step_geometries(ostride=16):
    """One config-#3 KD step at output stride `ostride` (x_kd_setup on
    x_batch), its kernel calls recorded: (every pass call of the student's
    backbone chains and of the teacher's eval entry blocks in order, as
    x_pass_sig geometries; the geometries of the other kernels in
    head_inputs', loss_inputs', resample_inputs' forms: {"head": HEAD_GEO's
    form, "loss": LOSS_GEO's, "ups": UP_GEO's, "dw": dw_geometries',
    "xsep": the teacher's folded sep convs as xeval_sig geometries}). The
    pass calls by kind and the student's depthwise calls by dilation must
    be x_train_passes' and x_eval_launches', and x_dw_dilations'."""
    from kd_cheap_conv_tpu_torch.ops import decoder as tdec
    from kd_cheap_conv_tpu_torch.ops import losses_fused as lf
    from kd_cheap_conv_tpu_torch.ops import separable as tsep
    from kd_cheap_conv_tpu_torch.ops import upsample as tup
    from kd_cheap_conv_tpu_torch.ops import xchain as txc
    from kd_cheap_conv_tpu_torch.ops import xchain_eval as xe

    model, teacher, step = x_kd_setup(ostride=ostride)
    images, labels = x_batch()
    sigs, rest = [], []
    # the student's train chains and the teacher's eval entry blocks
    passes = ([(txc, f"run_{n}") for n in ("bn_pw", "bn_dw", "bn_dw_s2",
                                             "pw_bwd", "dw_bwd",
                                             "dw_s2_bwd")]
              + [(xe, f"run_{n}") for n in ("bn_pw", "bn_dw", "bn_dw_s2")])
    others = [(tdec, "run_sep_fwd"), (tdec, "run_head_fwd"),
              (tsep, "run_separable"), (tsep, "run_dw_conv"),
              (tup, "run_up_fwd"), (lf, "ce_kl_upsampled_fwd"),
              (xe, "run_xsep_eval")]
    with recorded_calls(passes, lambda n, a, kw: x_pass_sig(n[4:], a, kw),
                        sigs), \
            recorded_calls(others, x_rest_sig, rest):
        step(images, labels)
    torch.cuda.synchronize()
    del model, teacher, step, images, labels
    torch.cuda.empty_cache()
    kinds, dils = {}, {}
    for sg in sigs:
        kinds[sg[0]] = kinds.get(sg[0], 0) + 1
        if sg[0] in ("dw", "dw_bwd") and sg[7]:      # the student's
            dils[sg[0], sg[4]] = dils.get((sg[0], sg[4]), 0) + 1
    train, evals = x_train_passes(ostride), x_eval_launches(ostride)
    want = {k: train[k] + {"pw": evals["xpw_fwd"], "dw": evals["bn_dw"],
                           "dw_s2": evals["bn_dw_s2"]}.get(k, 0)
            for k in train}
    if kinds != want or dils != x_dw_dilations(ostride):
        raise SystemExit(f"x_step_geometries: expected {want} pass calls in "
                         f"a step, the student's depthwise by dilation "
                         f"{x_dw_dilations(ostride)}, got {kinds}, {dils}")
    by = {}
    for r in rest:
        by.setdefault(r[0], []).append(r[1:])
    # per step: P1 and P2 once, 3 separable branches and their depthwise
    # recompute, 2 upsample forwards (the teacher's and the student's), C
    # once, the teacher's 54 folded sep convs
    counts = {k: len(v) for k, v in by.items()}
    if counts != {"head": 1, "classes": 1, "sep": 3, "dw": 3, "up": 2,
                  "loss": 1, "xsep": XSEP_CONVS}:
        raise SystemExit(f"x_step_geometries: unexpected kernel calls "
                         f"{counts}")
    (low, cu, cm), = by["head"]
    (ncls,), = by["classes"]
    (lshape, _, largs), = by["loss"]
    at = "config #3" if ostride == 16 else f"config #3 OS{ostride}"
    geo = {"head": {"at": at, "n": low[0], "hw": low[1:3],
                    "cl": low[3], "cu": cu, "cm": cm, "ncls": ncls,
                    "sep": {dil: (shape, co)
                            for shape, co, dil in by["sep"]}},
           "loss": {"at": at, "shape": lshape, "args": largs},
           "ups": [(f"x{ostride} b{shape[0]}", shape, size)
                   for shape, size in dict.fromkeys(by["up"])],
           "dw": [(f"x{ostride} aspp d{dil}", shape, k, dil, dt)
                  for shape, k, dil, dt in by["dw"]],
           "xsep": [sg for (sg,) in by["xsep"]]}
    phase("x_step_geometries", output_stride=ostride, passes=kinds,
          student_depthwise_by_dilation={f"{k} d{d}": n
                                         for (k, d), n in dils.items()},
          head={k: v for k, v in geo["head"].items() if k != "sep"},
          separable=[[list(sh), co, d] for d, (sh, co)
                     in geo["head"]["sep"].items()],
          loss={"shape": list(lshape), "args": list(largs)},
          upsample=[[list(sh), list(sz)] for _, sh, sz in geo["ups"]],
          depthwise=[[list(sh), k, d, str(dt)[6:]]
                     for _, sh, k, d, dt in geo["dw"]],
          folded_sep_convs=[[list(sg[0]), *sg[1:]]
                            for sg in dict.fromkeys(geo["xsep"])])
    return sigs, geo


def x_pass_args(sig, dtype, g):
    """Seeded inputs of one pass at its geometry (pass_args' conventions):
    the wrapper's positional arguments."""
    from kd_cheap_conv_tpu_torch.ops import stem as tst

    kind, shape, co, act, _, has_bn, has_pn, _ = sig
    ci = shape[-1]

    def randn(*s, scale=1.0):
        return scale * torch.randn(s, device="cuda", generator=g)

    def bn_pack(c):
        return torch.stack([randn(c, scale=0.1),
                            0.5 + torch.rand(c, device="cuda", generator=g),
                            1 + randn(c, scale=0.2), randn(c, scale=0.1)], 1)

    bn = bn_pack(ci) if has_bn else None
    wk = (randn(co, ci, scale=ci ** -0.5).to(dtype) if kind.startswith("pw")
          else randn(ci, 9, scale=1 / 3))
    x = randn(*shape).to(dtype)
    if not kind.endswith("bwd"):
        return (x, bn, wk, act, tst.EPS)
    s = 2 if kind == "dw_s2_bwd" else 1
    out = (shape[0], (shape[1] - 1) // s + 1, (shape[2] - 1) // s + 1, co)
    m = out[0] * out[1] * out[2]
    pn = None
    if has_pn:
        pn = torch.stack([randn(co, scale=0.1),
                          0.5 + torch.rand(co, device="cuda", generator=g),
                          1 + randn(co, scale=0.2), randn(co, scale=m ** 0.5),
                          randn(co, scale=m ** 0.5),
                          torch.full((co,), 1.0 / m, device="cuda")], 1)
    return (randn(*out).to(dtype), randn(*out).to(dtype), x, pn, bn, wk, act,
            tst.EPS)


# geometry kind -> the rows of X_PASSES that run it
X_ROWS = {"pw": ("xpw_fwd",), "pw_bwd": ("xpw_dgrad", "xpw_wgrad"),
          "dw": ("x_bn_dw",), "dw_s2": ("x_bn_dw_s2",),
          "dw_bwd": ("x_dw_bwd",), "dw_s2_bwd": ("x_dw_s2_bwd",)}


def x_pass_fns(row, sig):
    """(kernel wrapper call, plain version call) of row on args, both
    returning tuples: the forward passes (y, mean, var), or (y,) without
    moments."""
    from kd_cheap_conv_tpu_torch.ops import stem as tst

    dil, moments = sig[4], sig[7]
    kernel = getattr(tst, X_PASSES[row][0])
    extra = {"dil": dil} if row in ("x_bn_dw", "x_dw_bwd") else {}
    if not moments:
        extra["moments"] = False

    def fwd_plain(ref):
        def run(*a):
            y, sums = ref(*a)
            return (y, *tst._moments(sums, tst._count(y)))[:1 + 2 * moments]
        return run

    plain = {"xpw_fwd": fwd_plain(tst.bn_pw_ref),
             "xpw_dgrad": tst.pw_dgrad_ref,
             "xpw_wgrad": lambda *a: (tst.pw_wgrad_ref(*a),),
             "x_bn_dw": fwd_plain(functools.partial(tst.bn_dw_ref, stride=1,
                                                    dil=dil)),
             "x_bn_dw_s2": fwd_plain(functools.partial(tst.bn_dw_ref,
                                                       stride=2)),
             "x_dw_bwd": functools.partial(tst.dw_bwd_ref, stride=1, dil=dil),
             "x_dw_s2_bwd": functools.partial(tst.dw_bwd_ref, stride=2)}[row]

    def run_kernel(*a):
        out = kernel(*a, **extra)
        out = out if isinstance(out, tuple) else (out,)
        if not moments and any(o is not None for o in out[1:]):
            raise SystemExit(f"{row}: moments=False returned moments")
        return out[:1] if not moments else out
    return run_kernel, plain


def xpass_parity(g, worst, sigs):
    """Phase xpass_parity: every widened and new pass kernel against its
    plain version at each distinct geometry of the config-#3 step, f32
    (TF32 off) and bf16, within PASS_TOL; every output twice, bit for bit
    (the moments and sums, dW and dk included)."""
    distinct = list(dict.fromkeys(sigs))
    for dtype in (torch.float32, torch.bfloat16):
        for sig in distinct:
            args = x_pass_args(sig, dtype, g)
            for row in X_ROWS[sig[0]]:
                kernel, plain = x_pass_fns(row, sig)
                got, again, want = kernel(*args), kernel(*args), plain(*args)
                torch.cuda.synchronize()
                errs = [rel_err(a, b) for a, b in zip(got, want)]
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                ok = same and all(r <= PASS_TOL[dtype] for r, _ in errs)
                key = f"{row}_d4" if sig[4] == 4 else row
                worst[key, dtype] = max(worst.get((key, dtype), 0.0),
                                        errs[0][1])
                phase("xpass_parity", kernel=key, shape=list(sig[1]),
                      co=sig[2], act=sig[3], dilation=sig[4], bn=sig[5],
                      next_bn=sig[6], moments=sig[7], dtype=str(dtype)[6:],
                      rel_errs=[r for r, _ in errs],
                      max_abs_errs=[d for _, d in errs],
                      twice_bit_identical=same, tol=PASS_TOL[dtype], ok=ok)
                if not ok:
                    raise SystemExit(f"xpass_parity failed: {row} at {sig} "
                                     f"{dtype}")
                del got, again, want
            del args


def x8_parity(g, worst, sigs, geo, done_sigs, done_geo):
    """Phase a of config #3 at OS8, at the geometries read from its step
    (x_step_geometries(8)) that OS16's checks did not cover: the pass
    kernels (xpass_parity: the middle flow at 4 x 97² x 728 and dilation 2,
    the exit flow at 97² and dilation 4, whose two instances keep errors in
    rows of their own, X_D4), the ASPP branches' separable conv at 4 x 97²
    x 2048 -> 256, dilations 12, 24, 36 (head_parity), the upsample 97² ->
    193² and the depthwise recompute, dx and dk at those dilations
    (resample_dw_parity), and the teacher's folded sep convs at 97²,
    dilations 2 and 4 (xeval_parity)."""
    seen = set(done_sigs)
    xpass_parity(g, worst, [sg for sg in sigs if sg not in seen])
    head_parity(g, worst, geo["head"], only=("sep",))
    resample_dw_parity(g, worst, geo["dw"], geo["ups"])
    seen = set(done_geo["xsep"])
    xeval_parity(g, worst, [sg for sg in geo["xsep"] if sg not in seen])


def xception_parity(seed=11):
    """Phase xception_parity: the config-#3 student's backbone, full depth
    (16 middle blocks), one train-mode step from fresh running statistics
    with momentum None at X_PARITY_BATCH x 769², through the chains in f32
    and through `_forward_modules` in f32 and f64, TF32 off: values (out and
    low_level), every parameter gradient, the batch and running statistics
    of every BN. Both f32 paths are held to the f64 one (X_TOL); the chains'
    pass launches are counted (63 / 60 / 3 forward, the same backward)."""
    from kd_cheap_conv_tpu_torch.models import build_model
    from kd_cheap_conv_tpu_torch.ops import stem as tst

    gen = torch.Generator().manual_seed(seed)
    bb = build_model(X_MODEL, X_CLS, 16, generator=gen).backbone
    for m in bb.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            m.weight.data = 1 + 0.2 * torch.randn(c, generator=gen)
            m.bias.data = 0.1 * torch.randn(c, generator=gen)
            m.reset_running_stats()
            m.momentum = None
    bb = bb.to("cuda", memory_format=torch.channels_last).train()
    if not (all(bb._fused_entry_ok(b) for b in (bb.block1, bb.block2,
                                                bb.block3))
            and bb._fused_middle_active() and bb._fused_tail_active()):
        raise SystemExit("xception_parity: the guards refuse the chains")
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((X_PARITY_BATCH, 3, X_CROP, X_CROP), device="cuda",
                    generator=g).contiguous(memory_format=torch.channels_last)
    hw, lw = (X_CROP - 1) // 16 + 1, (X_CROP - 1) // 4 + 1
    wo, wl = (torch.randn(s, device="cuda", generator=g).contiguous(
        memory_format=torch.channels_last)
        for s in ((X_PARITY_BATCH, 2048, hw, hw),
                  (X_PARITY_BATCH, 128, lw, lw)))
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in bb.modules())
    torch.cuda.reset_peak_memory_stats()

    def step(model, xin, modules):
        o = model._forward_modules(xin) if modules else model(xin)
        ((o["out"] * wo.to(o["out"].dtype)).sum()
         + (o["low_level"] * wl.to(o["low_level"].dtype)).sum()).backward()
        torch.cuda.synchronize()
        outs = {k: o[k].detach().double() for k in ("out", "low_level")}
        grads = {k: p.grad.double() for k, p in model.named_parameters()}
        stats = {k: b.double() for k, b in model.named_buffers()
                 if k.endswith(("running_mean", "running_var"))}
        return outs, grads, stats

    ref = step(copy.deepcopy(bb).double(), x.double(), True)
    mod = step(copy.deepcopy(bb), x, True)
    for fn in tst.PASSES + tst.WIDE_PASSES:
        fn.launches = 0
    ch = step(bb, x, False)
    launches = {fn.__name__[4:]: fn.launches
                for fn in tst.PASSES + tst.WIDE_PASSES}
    peak = torch.cuda.max_memory_allocated() / 2**30

    def l2(a, b):
        return float((a - b).norm())

    def rel(path, kind):
        return max(l2(path[kind][k], ref[kind][k]) / float(ref[kind][k].norm())
                   for k in ref[kind])

    res = {"values": rel(ch, 0), "values_modules": rel(mod, 0)}
    floor = 1e-7 * max(float(v.norm()) for v in ref[1].values())
    ratios = sorted(((l2(ch[1][k], ref[1][k])
                      / (l2(mod[1][k], ref[1][k]) + floor), k)
                     for k in ref[1]), reverse=True)
    res["grads_vs_modules_noise"], res["grads_worst"] = (ratios[0][0],
                                                         ratios[:3])
    big = 1e4 * floor
    res["grads_rel_l2_max"] = [max(l2(p[1][k], ref[1][k])
                                   / max(float(ref[1][k].norm()), big)
                                   for k in ref[1]) for p in (ch, mod)]
    res["stats"], res["stats_modules"] = (
        max(rel_err(p[2][k], ref[2][k])[0] for k in ref[2])
        for p in (ch, mod))
    want = {"bn_pw": 0, "bn_dw": 60, "bn_dw_s2": 3, "pw_bwd": 0,
            "dw_bwd": 60, "dw_s2_bwd": 3, "bn_pw_wide": 63,
            "xpw_dgrad": 63, "xpw_wgrad": 63}
    ok = (launches == want and len(ref[2]) == 2 * n_bn
          and res["values"] <= max(X_TOL["floor"],
                                   X_TOL["vs_noise"] * res["values_modules"])
          and res["stats"] <= max(X_TOL["stats_floor"],
                                  X_TOL["vs_noise"] * res["stats_modules"])
          and res["grads_vs_modules_noise"] <= X_TOL["vs_noise"])
    phase("xception_parity", what=f"Xception-65 backbone, train mode, "
          f"{X_PARITY_BATCH} x {X_CROP}², chains (f32) and _forward_modules "
          f"(f32) against _forward_modules in f64", launches=launches,
          bns=n_bn, **res, tol=X_TOL,
          peak_mem_gb=round(peak, 2), ok=ok)
    if not ok:
        raise SystemExit(f"xception_parity: the chains disagree with the "
                         f"module path in f64, or ran {launches}")
    del ref, mod, ch, bb


# ---------------------------------------------------------------------------
# config #3's eval chains: the teacher's forward, Xception serving
# ---------------------------------------------------------------------------

def xeval_sig(a, kw):
    """A folded sep conv's geometry from its wrapper's arguments: (input
    NHWC shape, Co, dilation, relu before?, relu after?, residual: None,
    "x0" or the skip's width, input f32?, output f32?)."""
    x, w = a[0], a[2]
    x0, wsk = kw.get("x0"), kw.get("wsk")
    res = None if x0 is None else "x0" if wsk is None else wsk.shape[1]
    return (tuple(x.shape), w.shape[0], kw["dil"], bool(kw["pre_relu"]),
            bool(kw["final_relu"]), res, x.dtype == torch.float32,
            kw["out_dtype"] == torch.float32)


def xeval_args(sig, dtype, g):
    """Seeded inputs of one folded sep conv at its geometry: the wrapper's
    (positional, keyword) arguments, operands in dtype (the input and
    output in f32 where the geometry has them so)."""
    shape, co, dil, pre, final, res, in32, out32 = sig
    n, h, w, ci = shape
    f32 = torch.float32

    def randn(*s, scale=1.0):
        return scale * torch.randn(s, device="cuda", generator=g)

    kw = {"dil": dil, "pre_relu": pre, "final_relu": final,
          "out_dtype": f32 if out32 else dtype}
    if res == "x0":
        kw["x0"] = randn(n, h, w, co).to(dtype)
    elif res is not None:
        kw.update(x0=randn(n, h, w, res).to(dtype),
                  wsk=randn(co, res, scale=res ** -0.5).to(dtype),
                  bsk=randn(co, scale=0.1))
    return ((randn(*shape).to(f32 if in32 else dtype),
             randn(9, ci, scale=1 / 3),
             randn(co, ci, scale=ci ** -0.5).to(dtype),
             randn(co, scale=0.1)), kw)


def xeval_split(args, kw):
    """The bf16 sep conv's two kernels alone on one call's arguments, each
    against its plain version on the same inputs (the product on the plain
    version's t): {kernel: (got, want)}."""
    from kd_cheap_conv_tpu_torch.ops import xchain_eval as xe

    x, taps, w, b = args
    rest = {k: v for k, v in kw.items() if k not in ("dil", "pre_relu")}
    dw = {"dil": kw["dil"], "pre_relu": kw["pre_relu"]}
    t_ref = xe.xsep_dw_ref(x, taps, **dw)
    return {"xsep_dw": (xe.run_xsep_dw(x, taps, **dw), t_ref),
            "xsep_mm": (xe.run_xsep_mm(t_ref, w, b, **rest),
                        xe.xsep_mm_ref(t_ref, w, b, **rest))}


def xeval_parity(g, worst, sigs):
    """Phase xeval_parity: the folded separable conv against its plain
    version at each distinct geometry of the config-#3 teacher's forward
    (read from its calls: 4 x 49², dilation 1 and 2, the residual and the
    skip, 728 .. 2048 channels, f32 and bf16 inputs and outputs; at OS8 4 x
    97², dilation 2 and 4): f32 (TF32 off) on
    xsep_eval_kernel, bf16 on the depthwise pass and the product, within
    PASS_TOL, every output twice, bit for bit, each kernel's launches
    counted; in bf16 each of the two kernels also alone against its plain
    version."""
    from kd_cheap_conv_tpu_torch.ops import xchain_eval as xe

    def counts():
        return {k: getattr(xe, v[0]).launches for k, v in XEVAL.items()}

    distinct = list(dict.fromkeys(sigs))
    for dtype in (torch.float32, torch.bfloat16):
        per_call = ({"xsep_eval": 1, "xsep_dw": 0, "xsep_mm": 0}
                    if dtype == torch.float32
                    else {"xsep_eval": 0, "xsep_dw": 1, "xsep_mm": 1})
        for sig in distinct:
            args, kw = xeval_args(sig, dtype, g)
            before = counts()
            got = xe.run_xsep_eval(*args, **kw)
            again = xe.run_xsep_eval(*args, **kw)
            ran = {k: v - before[k] for k, v in counts().items()}
            want = xe.xsep_eval_ref(*args, **kw)
            alone = xeval_split(args, kw) if dtype == torch.bfloat16 else {}
            torch.cuda.synchronize()
            rel, d = rel_err(got, want)
            same = torch.equal(got, again)
            kernel_rel = {}
            for k, (kg, kw_) in alone.items():
                kernel_rel[k], kd = rel_err(kg, kw_)
                worst[k, dtype] = max(worst.get((k, dtype), 0.0), kd)
            ok = (same and got.dtype == want.dtype and rel <= PASS_TOL[dtype]
                  and ran == {k: 2 * v for k, v in per_call.items()}
                  and all(r <= PASS_TOL[dtype] for r in kernel_rel.values()))
            if dtype == torch.float32:
                worst["xsep_eval", dtype] = max(
                    worst.get(("xsep_eval", dtype), 0.0), d)
            phase("xeval_parity", shape=list(sig[0]), co=sig[1],
                  dilation=sig[2], relu_before=sig[3], relu_after=sig[4],
                  residual=sig[5], in_f32=sig[6], out_f32=sig[7],
                  dtype=str(dtype)[6:], rel_err=rel, max_abs_err=d,
                  kernel_rel_err=kernel_rel, launches=ran,
                  twice_bit_identical=same, tol=PASS_TOL[dtype], ok=ok)
            if not ok:
                raise SystemExit(f"xeval_parity failed at {sig} {dtype}")
            del args, kw, got, again, want, alone


def x_calibrated(dtype=None, seed=2, surgery=False, ostride=16):
    """A config-#3 DeepLabV3+ Xception-65 (19 classes, output stride `ostride`)
    with seeded
    weights (the student's head separable-converted if `surgery`) and BN
    statistics calibrated on two seeded 769² images (calibrate_bn), in eval
    mode on the card; with dtype bf16, the teacher as main builds it."""
    from kd_cheap_conv_tpu_torch.kd.replace import (CheapConvSpec,
                                                    replace_cheap_convs)
    from kd_cheap_conv_tpu_torch.models import build_model

    g = torch.Generator().manual_seed(seed)
    m = build_model(X_MODEL, X_CLS, ostride, dtype=dtype, generator=g)
    if surgery:
        replace_cheap_convs(m, CheapConvSpec(), scope="classifier",
                            generator=g)
    m = calibrate_bn(m, seed=7, size=X_CROP, n_cls=X_CLS)
    return m.to("cuda", memory_format=torch.channels_last).eval()


def xception_eval_parity(kernels, seed=12):
    """Phase xception_eval_parity: the full-depth Xception-65 backbone in
    eval mode under no_grad at 4 x 769² (calibrated BN statistics), through
    the eval chains in f32 and through `_forward_modules` in f32, both
    against `_forward_modules` in f64, TF32 off: out and low_level, the
    chains within X_EVAL_TOL; exactly x_eval_launches(f32=True) launches per
    forward and no other kernel of the port."""
    bb = x_calibrated(seed=seed).backbone
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((X_BATCH, 3, X_CROP, X_CROP), device="cuda",
                    generator=g).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        for fn in kernels.values():
            fn.launches = 0
        ch = bb(x)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in kernels.items()
                    if fn.launches}
        mod = bb._forward_modules(x)
        ref = copy.deepcopy(bb).double()._forward_modules(x.double())
    torch.cuda.synchronize()
    res = {}
    for k in ("out", "low_level"):
        res[k] = {"chains": rel_err(ch[k], ref[k])[0],
                  "modules": rel_err(mod[k], ref[k])[0],
                  "max_abs_f64": float(ref[k].abs().max())}
    ok = launches == x_eval_launches(f32=True) and all(
        torch.isfinite(ch[k]).all() and r["chains"] <= max(
            X_EVAL_TOL["floor"], X_EVAL_TOL["vs_noise"] * r["modules"])
        for k, r in res.items())
    phase("xception_eval_parity", what=f"Xception-65 backbone, eval, "
          f"no_grad, {X_BATCH} x {X_CROP}², eval chains (f32) and "
          f"_forward_modules (f32) against _forward_modules in f64",
          launches=launches, want=x_eval_launches(f32=True), rel_err=res,
          tol=X_EVAL_TOL, ok=bool(ok))
    if not ok:
        raise SystemExit(f"xception_eval_parity: the eval chains disagree "
                         f"with the module path in f64, or ran {launches}")
    del bb, ch, mod, ref


def main_x(kernels, card, ostride=16):
    """Phase main_x: Xception serving through main.main (`X_SERVE_ARGS`:
    the config-#3 student at 769², bf16, at output stride `ostride`), plain
    validate and TTA, counted from zero: a finite mIoU and exactly
    x_eval_launches(ostride), 4 separable and 1 upsample launches per forward
    and no other. Then f32 logits of a
    calibrated model through the eval chains against the fully stock path
    (autograd on, so every block runs its modules, and the separable,
    depthwise and upsample kernels off: no kernel of the port), within
    1e-3 x max(1, max |logit|) with argmax agreement >= 99.9% (phase
    x_logits)."""
    forwards = math.ceil(N_VAL / X_BATCH)
    serve = X_SERVE_ARGS + ["--output_stride", str(ostride)]
    per_fwd = {**x_eval_launches(ostride), "sep": 4, "up_fwd": 1}
    for extra, fwd in (([], forwards),
                       (["--tta", "--tta_scales", TTA_SCALES],
                        forwards * len(TTA_SCALES.split(",")))):
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        miou = run_main(extra, serve)
        wall = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in kernels.items()}
        want = {k: per_fwd.get(k, 0) * fwd for k in kernels}
        phase("main_x", args=" ".join(serve + extra), mean_iou=miou,
              forwards=fwd, launches={k: v for k, v in got.items() if v},
              wall_s=round(wall, 2), ok=got == want)
        if got != want:
            off = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
            raise SystemExit(f"main_x: launches (got, want) {off}")
    from kd_cheap_conv_tpu_torch.data import SyntheticSegmentation

    model = x_calibrated(seed=3, surgery=True, ostride=ostride)
    val = SyntheticSegmentation(X_CLS, size=X_CROP, length=2, seed=2)
    x = torch.from_numpy(np.stack([val[i][0] for i in range(2)])).float()
    x = x.cuda().permute(0, 3, 1, 2)
    for fn in kernels.values():
        fn.launches = 0
    with torch.no_grad():
        fused = model(x)
    in_fused = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    for fn in kernels.values():
        fn.launches = 0
    plain = stock_model(model)(x).detach()
    torch.cuda.synchronize()
    in_plain = {k: fn.launches for k, fn in kernels.items() if fn.launches}
    err = float((fused - plain).abs().max())
    scale = float(plain.abs().max())
    agree = share_of(fused.argmax(1) == plain.argmax(1))
    ok = (bool(torch.isfinite(fused).all()) and err <= 1e-3 * max(1.0, scale)
          and agree >= 0.999 and not in_plain
          and in_fused == {**x_eval_launches(ostride, f32=True), "sep": 4,
                           "up_fwd": 1})
    phase("x_logits", output_stride=ostride, shape=list(fused.shape),
          max_abs_err=err,
          max_abs_logit=scale, argmax_agree=agree,
          kernel_path_launches=in_fused, plain_path_launches=in_plain,
          card=card, ok=ok)
    if not ok:
        raise SystemExit("x_logits: the eval chains and the plain path "
                         f"disagree (plain path launched {in_plain})")
    del model, fused, plain
    x_logits_bf16(kernels, x, card, ostride)


def xsep_eval_f64(x, taps, w, b, *, dil=1, pre_relu=True, final_relu=False,
                  x0=None, wsk=None, bsk=None, out_dtype=None):
    """A folded sep conv with t rounded to w's dtype as the kernels and the
    plain version round it, and the products, bias, residual or skip in
    f64 (x_logits_bf16's more exact reference)."""
    from kd_cheap_conv_tpu_torch.ops import xchain_eval as xe

    t = xe.xsep_dw_ref(x, taps, dil=dil, pre_relu=pre_relu, dtype=w.dtype)
    y = t.double() @ w.double().t() + b.double()
    if x0 is not None and wsk is None:
        y = y + x0.double()
    elif x0 is not None:
        y = y + (x0.double() @ wsk.double().t() + bsk.double())
    if final_relu:
        y = y.clamp_min(0.0)
    return y.to(out_dtype or w.dtype).contiguous()


def x_logits_bf16(kernels, x, card, ostride=16):
    """Phase x_logits_bf16: the bf16 config-#3 student (calibrated, eval,
    no_grad) through the eval chains, whose sep convs run the depthwise
    pass and the TMA + wgmma product, against the same model with every
    folded sep conv on its plain version xsep_eval_ref (the rest of the
    forward identical), and both against a more exact path (f64 products,
    xsep_eval_f64): finite logits, max abs error over max |logit| and the
    argmax agreements reported. A random bf16 network amplifies a last-ulp
    difference of one sep conv into flipped argmaxes, so the argmax check
    counts only robust pixels: those whose top-2 logit margin on the f64
    path exceeds twice the plain path's largest abs difference from it (the
    plain path's own bf16 error bound; there the plain path agrees with the
    f64 path by construction). On them the kernel path's argmax must equal
    the f64 path's at 100%, counted as flips in integers (a float mean on
    the card can read 1 - 2**-24 with no flip); their share is reported."""
    from kd_cheap_conv_tpu_torch.ops import xchain_eval as xe

    model = x_calibrated(torch.bfloat16, seed=3, surgery=True, ostride=ostride)
    for fn in kernels.values():
        fn.launches = 0
    out, kernel_sep = {}, xe.run_xsep_eval
    with torch.no_grad():
        out["kernel"] = model(x).float()
        launched = {k: fn.launches for k, fn in kernels.items()
                    if fn.launches}
        try:
            for name, fn in (("plain", xe.xsep_eval_ref),
                             ("f64", xsep_eval_f64)):
                xe.run_xsep_eval = fn
                out[name] = model(x).float()
        finally:
            xe.run_xsep_eval = kernel_sep
    torch.cuda.synchronize()

    def same(a, b, where=None):
        hit = out[a].argmax(1) == out[b].argmax(1)
        return hit if where is None else hit[where]

    def agree(a, b, where=None):
        return share_of(same(a, b, where))

    err = float((out["kernel"] - out["plain"]).abs().max())
    scale = float(out["plain"].abs().max())
    noise = float((out["plain"] - out["f64"]).abs().max())
    top2 = out["f64"].topk(2, dim=1).values
    robust = (top2[:, 0] - top2[:, 1]) > 2 * noise
    share = share_of(robust)
    on_robust = agree("kernel", "f64", robust)
    flips = {k: int((~same(k, "f64", robust)).sum())
             for k in ("kernel", "plain")}
    ok = (bool(torch.isfinite(out["kernel"]).all())
          and launched == {**x_eval_launches(ostride), "sep": 4, "up_fwd": 1}
          and flips["kernel"] == 0)
    phase("x_logits_bf16", output_stride=ostride,
          shape=list(out["kernel"].shape), max_abs_err=err,
          max_abs_logit=scale, err_over_max_logit=err / max(scale, 1e-30),
          argmax_agree=agree("kernel", "plain"),
          argmax_agree_kernel_vs_f64=agree("kernel", "f64"),
          argmax_agree_plain_vs_f64=agree("plain", "f64"),
          max_abs_err_vs_f64={
              "kernel": float((out["kernel"] - out["f64"]).abs().max()),
              "plain": noise},
          robust_pixel_share=share,
          robust_argmax_agree_vs_f64={
              "kernel": on_robust, "plain": agree("plain", "f64", robust)},
          robust_flips_vs_f64=flips,
          kernel_path_launches=launched, card=card, ok=ok)
    if not ok:
        raise SystemExit(f"x_logits_bf16: {flips['kernel']} argmax flips "
                         f"(agreement {on_robust}) against the f64 path on "
                         f"robust pixels (share {share}), "
                         f"launches {launched}")
    del model, out


def x_kd_setup(seed=1, ostride=16):
    """Student, calibrated teacher, optimizer and KD step as main builds
    them for config #3 at output stride `ostride`."""
    from kd_cheap_conv_tpu_torch.kd.distill import KDConfig
    from kd_cheap_conv_tpu_torch.train.optim import make_optimizer
    from kd_cheap_conv_tpu_torch.train.steps import make_kd_train_step

    teacher = x_calibrated(torch.bfloat16, seed + 1, ostride=ostride)
    model = x_student(torch.bfloat16, seed, ostride=ostride)
    opt, sched = make_optimizer(model.named_parameters(), lr=0.01,
                                max_iters=1000)
    return model, teacher, make_kd_train_step(model, teacher, opt,
                                              KDConfig(), sched)


def x_step_kernel_launches(ostride=16):
    """Launches of each of the port's kernel functions in one config-#3 KD
    step at output stride `ostride`; at OS8 also of the depthwise forward's and
    backward's dilation-4 instances (the names as patterns of the profiled
    kernel's demangled name)."""
    want = {v: 1 for v in LOSS_KERNELS.values()}
    for name, per_step, _ in HEAD_KERNELS.values():
        want[name] = want.get(name, 0) + per_step
    for k, n in (("up_fwd", 2), ("up_bwd", 1), ("dw_conv", 3), ("dw_dx", 3),
                 ("dw_dk", 3)):
        name = RESAMPLE_KERNELS[k][0]
        want[name] = want.get(name, 0) + n
    train, evals = x_train_passes(ostride), x_eval_launches(ostride)
    per_step = {"xpw_fwd": train["pw"] + evals["xpw_fwd"],
                "xpw_dgrad": train["pw_bwd"], "xpw_wgrad": train["pw_bwd"],
                "x_bn_dw": train["dw"] + evals["bn_dw"],
                "x_bn_dw_s2": train["dw_s2"] + evals["bn_dw_s2"],
                "x_dw_bwd": train["dw_bwd"], "x_dw_s2_bwd": train["dw_s2_bwd"]}
    for row, (_, name, _, _, _) in X_PASSES.items():
        want[name] = want.get(name, 0) + per_step[row]
    for _, name, per_forward in XEVAL.values():
        if per_forward:
            want[name] = per_forward
    if ostride == 8:
        for row in X_D4:
            want[rf"{X_PASSES[row][1]}<[^<>]*,\s*1,\s*4>"] = 6
    return want


def train_x(kernels, card, ostride=16):
    """Phase train_x: the config-#3 command at output stride `ostride` through
    main.main (4 KD steps, validation at the end), counted from zero; at
    OS8 also the dilation-4 instances' launches. Returns the counts."""
    from kd_cheap_conv_tpu_torch import main as port_main

    forwards = math.ceil(N_VAL / BATCH)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        for fn in kernels.values():
            fn.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with calibrated_teacher_builds(X_MODEL, skip=1, size=X_CROP,
                                       n_cls=X_CLS), \
                contextlib.redirect_stdout(out):
            rc = port_main.main(x_args(ostride) + ["--ckpt_dir", ckpt_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in kernels.items()}
        text = out.getvalue()
        sys.stdout.write(text)
        ckpts = sorted(os.listdir(ckpt_dir))
    losses = [float(line.split("loss=")[1].split(",")[0])
              for line in text.splitlines() if line.startswith("Itrs")]
    s = X_STEPS
    # per step (the student's train chains and the teacher's eval entry
    # blocks; the teacher's eval middle and exit flow); the teacher's one
    # train-mode calibration pass runs the forward train chains (OS16: 63 /
    # 60 / 3; OS8: 60 / 58 / 2, 6 of the depthwise at dilation 4) and its
    # decoder upsample once; each validation forward runs the eval chains
    # (x_eval_launches), the separable kernel 4 times and the upsample once
    train, evals = x_train_passes(ostride), x_eval_launches(ostride)
    want = {k: 0 for k in kernels}
    want.update({"C": s, "D": s, "xpw_dgrad": train["pw_bwd"] * s,
                 "xpw_wgrad": train["pw_bwd"] * s,
                 "dw_bwd": train["dw_bwd"] * s,
                 "dw_s2_bwd": train["dw_s2_bwd"] * s,
                 "sep": 3 * s + 4 * forwards, "sep_fwd": s, "head_fwd": s,
                 "head_bwd": s, "sep_bwd": s,
                 "up_fwd": 2 * s + 1 + forwards, "up_bwd": s,
                 "dw_conv": 3 * s, "dw_dx": 3 * s, "dw_dk": 3 * s})
    for k, kind in (("xpw_fwd", "pw"), ("bn_dw", "dw"),
                    ("bn_dw_s2", "dw_s2")):
        want[k] = ((train[kind] + evals[k]) * s + train[kind]
                   + evals[k] * forwards)
    want["xsep_dw"] = want["xsep_mm"] = XSEP_CONVS * (s + forwards)
    if ostride == 8:
        want["x_bn_dw_d4"], want["x_dw_bwd_d4"] = 6 * s + 6, 6 * s
    latest = f"latest_{X_MODEL}_synthetic_os{ostride}.pth"
    ok = (rc == 0 and len(losses) == s // 2 and all(map(math.isfinite,
                                                         losses))
          and got == want and latest in ckpts)
    phase("train_x", args=" ".join(x_args(ostride)), wall_s=round(wall, 2),
          launches=got, want=want, losses=losses, checkpoints=ckpts,
          card=card, ok=ok)
    if not ok:
        off = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
        raise SystemExit(f"train_x: rc {rc}, losses {losses}, launches "
                         f"(got, want) {off}, checkpoints {ckpts}")
    return got


def x_rate(card, ostride=16):
    """Phase x_rate: config-#3 KD images/s at output stride `ostride` on a
    device-resident batch (12 untraced steps after 3 of warm-up: median and
    quartiles) and peak device memory. Returns (the step on its batch, the
    median step ms) for x_profile."""
    images, labels = x_batch()
    _, _, step = x_kd_setup(ostride=ostride)
    for _ in range(3):
        step(images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(12):
        t0 = time.perf_counter()
        metrics = step(images, labels)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = statistics.quantiles(times, n=4)
    peak = torch.cuda.max_memory_allocated() / 2**30
    phase("x_rate", what=f"config #3 KD step ({X_MODEL} teacher and "
          f"student), {X_CROP}², batch {X_BATCH}, bf16, device-resident "
          f"batch", output_stride=ostride, steps=len(times),
          median_img_per_s=round(X_BATCH / med * 1e3, 2),
          q1_img_per_s=round(X_BATCH / q3 * 1e3, 2),
          q3_img_per_s=round(X_BATCH / q1 * 1e3, 2),
          median_step_ms=round(med, 3), peak_mem_gb=round(peak, 2),
          loss=float(metrics["loss"]), card=card)
    return (lambda: step(images, labels)), med


def x_profile(step, med, card, ostride=16):
    """Phase x_profile: one profiled config-#3 KD step at output stride
    `ostride` by kernel class (device_split: the teacher's folded sep convs in
    xeval, the wide 1x1 passes in wide_pw, the depthwise passes in
    bn_passes, every kernel of the port present with its count, at OS8 the
    dilation-4 instances too) and the device's idle share against the
    untraced median step."""
    head = {}
    want = x_step_kernel_launches(ostride)
    split, top_other, rounds = device_split(step, want, head=head)
    busy = sum(split.values())
    phase("x_profile", what=f"one config-#3 KD step, {X_CROP}², batch "
          f"{X_BATCH}, bf16", output_stride=ostride,
          launches={k.split("<")[0] + ("<T, 1, 4>" if "<" in k else ""): v
                    for k, v in want.items()},
          device_ms={k: round(v, 3)
                                         for k, v in split.items()},
          head_ms_by_kernel=head,
          top_other=top_other, profiled_rounds=rounds,
          device_busy_ms=round(busy, 3), untraced_step_ms=round(med, 3),
          device_idle_share=round(1 - busy / med, 3) if busy else None,
          card=card)


def x_pass_bound_ms(row, sig, esize=2):
    """Least time of one pass call on the card, as (bytes ms, FLOP ms): each
    activation read or written once in the activation dtype, weights and
    BN packs once; the products over the bf16 tensor-core peak."""
    _, shape, co, _, _, _, has_pn, _ = sig
    n, h, w, ci = shape
    p = n * h * w
    if row.startswith("xpw"):
        flops = 2 * p * ci * co
        if row == "xpw_fwd":
            nbytes = esize * (p * (ci + co) + co * ci)
        elif row == "xpw_dgrad":
            nbytes = esize * (p * co * (1 + has_pn) + 2 * p * ci + co * ci)
        else:
            nbytes = esize * p * (co * (1 + has_pn) + ci) + 4 * co * ci
        nbytes += 16 * (ci + co)
    else:
        s = 2 if "s2" in row else 1
        po = n * ((h - 1) // s + 1) * ((w - 1) // s + 1)
        if row.endswith("bwd"):
            nbytes, flops = esize * 2 * (po + p) * ci, 36 * po * ci
        else:
            nbytes, flops = esize * (p + po) * ci, 18 * po * ci
        nbytes += 36 * ci + 40 * ci
    return nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3


def x_pass_stock(row, sig, args):
    """(the stock sequence the pass replaces, the one PyTorch call that
    computes its product or conv) on args, bf16, channels_last: forward,
    the input BN in train mode (its moments and normalisation), the
    activation and the conv (cuDNN); backward, autograd through that
    sequence (dgrad: the input and BN-affine gradients; wgrad: the weight's;
    depthwise: all). The library call: torch.matmul for the 1x1 products,
    F.conv2d and aten.convolution_backward for the depthwise."""
    import torch.nn.functional as F

    _, shape, co, act, dil, _, _, _ = sig
    ci = shape[-1]
    s = 2 if "s2" in row else 1
    x = args[2] if row.startswith(("xpw_d", "xpw_w", "x_dw")) else args[0]
    xn = x.permute(0, 3, 1, 2).detach()
    dw = not row.startswith("xpw")
    wk = args[5] if row.endswith(("bwd", "grad")) else args[2]
    wt = (wk.to(x.dtype).reshape(ci, 1, 3, 3) if dw
          else wk.reshape(co, ci, 1, 1))
    gam = torch.ones(ci, device="cuda", requires_grad=True)
    bet = torch.zeros(ci, device="cuda", requires_grad=True)

    def seq(xin, wgt):
        u = F.batch_norm(xin, None, None, gam, bet, True, 0.0, 1e-5)
        hh = F.relu(u) if act == "relu" else u
        if dw:
            return F.conv2d(hh, wgt, None, s, dil, dil, ci)
        return F.conv2d(hh, wgt)

    if not row.endswith(("bwd", "grad")):
        def lib():
            if dw:
                return F.conv2d(xn, wt, None, s, dil, dil, ci)
            return torch.matmul(x.reshape(-1, ci), wk.t())
        return (lambda: seq(xn, wt)), lib
    xr = xn.detach().requires_grad_()
    wr = wt.detach().requires_grad_()
    y = seq(xr, wr)
    gy = args[0].permute(0, 3, 1, 2)
    want = {"xpw_dgrad": (xr, gam, bet), "xpw_wgrad": (wr,),
            "x_dw_bwd": (xr, wr, gam, bet),
            "x_dw_s2_bwd": (xr, wr, gam, bet)}[row]

    def stock():
        return torch.autograd.grad(y, want, gy, retain_graph=True)

    ga = args[0].reshape(-1, co)
    if row == "xpw_dgrad":
        def lib():
            return torch.matmul(ga, wk)
    elif row == "xpw_wgrad":
        zz = x.reshape(-1, ci)

        def lib():
            return torch.matmul(ga.t(), zz)
    else:
        hd = xn.detach()

        def lib():
            return torch.ops.aten.convolution_backward(
                gy, hd, wt, None, [s, s], [dil, dil], [dil, dil], False,
                [0, 0], ci, [True, True, False])
    return stock, lib


def x_dev_ms(fn):
    """device_ms_all over one profiled round of 3 calls; three rounds where
    that round lost its device events."""
    return device_ms_all(fn, iters=3, rounds=1) or device_ms_all(fn, iters=3)


def x_partial_shapes(row, sig):
    """The f32 CTA partials a pass wrapper allocates for one call, as
    (shape, summed by torch): the wide dgrad's sums (grid, 2, Ci), which
    the wrapper sums over the first dimension with torch; the bf16 wide
    forward's moment partials ((CTAs + groups) x 2 x Co,
    xpw_fwd_scratch_floats) and the bf16 weight gradient's split fragments
    (tiles x splits, 128, BN), which the kernels sum themselves (none for
    one split); the depthwise backward's sums (grid, 2, C) and dk (grid, 9,
    C), which the wrapper sums with torch; the depthwise forward's moments,
    which the kernel sums over a scratch of (CTAs + groups) x 2 x C
    (ops.stem.bn_dw_fwd_plan); none for a forward pass without moments (the
    eval entry blocks'). The depthwise backward's grid is sized to the card
    (ops.stem.dw_bwd_grid)."""
    from kd_cheap_conv_tpu_torch.ops import stem as tst

    _, shape, co, _, _, _, _, moments = sig
    n, h, w, ci = shape
    if row in ("xpw_fwd", "x_bn_dw", "x_bn_dw_s2") and not moments:
        return []
    if row == "xpw_fwd":
        return [((tst.xpw_fwd_scratch_floats(n * h * w, co),), False)]
    if row == "xpw_wgrad":
        bn, tiles, splits, _ = tst.xpw_wgrad_plan(n * h * w, ci, co)
        return [((tiles * splits, tst.XPW_BM, bn), False)] if splits > 1 \
            else []
    if row == "xpw_dgrad":
        grid = tst._xpw_grid(tst.XPW_DGRAD, torch.bfloat16, n * h * w, ci, co)
        return [((grid, 2, ci), True)]
    s = 2 if "s2" in row else 1
    if row.endswith("bwd"):
        grid = tst.dw_bwd_grid(torch.bfloat16, n, h, w, ci, s, sig[4])
        return [((grid, 2, ci), True), ((grid, 9, ci), True)]
    pl = tst.bn_dw_fwd_plan(n, h, w, ci, s, sig[4], 2)
    return [((pl.scratch_floats,), False)]


# the redesigned kernels whose xpass_time also prints each geometry, and
# those whose row gives the wrapper's host time per call (host_us, weighted
# by the calls)
X_PER_GEOMETRY = ("xpw_fwd", "xpw_dgrad", "xpw_wgrad", "x_bn_dw", "x_bn_dw_s2")
X_HOST = ("xpw_fwd", "x_bn_dw", "x_bn_dw_s2")


def xpass_time(g, sigs, total, bound, stock, product, card):
    """Phase xpass_time: each Xception pass kernel summed over its calls in
    one config-#3 KD step (bf16, each distinct geometry timed once and
    weighted by its calls): the device time of its wrapper, of its plain
    version, of the stock sequence it replaces and of the one PyTorch call
    computing its product or conv alone (for the wide 1x1 kernels,
    torch.matmul of the same (M x K) . (K x N) bf16 product), and its
    bound. No one PyTorch call computes a pass's whole function (the BN
    prologue and the moment or sum epilogue with the conv), so the kernels
    line gives these rows no library time and the product's as
    product_ms. Also the f32 CTA partials per step (partial_mb,
    x_partial_shapes: those the wrapper sums with torch and those the
    kernel sums itself) and the device time of the torch sums alone
    (reduce_ms, included in ms). The kernels of X_PER_GEOMETRY also get a
    line per distinct geometry (phase xpass_geometry): kernel ms,
    torch.matmul ms of its product, bound and calls per step; those of
    X_HOST the wrapper's host microseconds per call (host_us), weighted by
    the calls."""
    counts = {}
    for sig in sigs:
        counts[sig] = counts.get(sig, 0) + 1
    rows, parts, hosts = {}, {}, {}
    for sig, cnt in counts.items():
        args = x_pass_args(sig, torch.bfloat16, g)
        for row in X_ROWS[sig[0]]:
            kernel, plain = x_pass_fns(row, sig)
            seq, lib = x_pass_stock(row, sig, args)
            # the kernel's own time: the median of three rounds (a single
            # round's figure for the wide forward moved by a quarter
            # between two calls)
            t = [device_ms_all(lambda: kernel(*args), iters=3),
                 x_dev_ms(lambda: plain(*args)), x_dev_ms(seq), x_dev_ms(lib)]
            bb, bo = x_pass_bound_ms(row, sig)
            r = rows.setdefault(row, [0.0] * 6)
            for i, v in enumerate((*t, bb, bo)):
                r[i] += cnt * v
            pr = parts.setdefault(row, [0.0, 0.0])
            for ps, by_torch in x_partial_shapes(row, sig):
                pr[0] += cnt * math.prod(ps) * 4 / 2**20
                if by_torch:
                    part = torch.zeros(ps, device="cuda")
                    pr[1] += cnt * x_dev_ms(lambda: part.sum(0))
                    del part
            if row in X_HOST:
                hu = hosts.setdefault(row, [0.0, 0])
                hu[0] += cnt * host_us(lambda: kernel(*args))
                hu[1] += cnt
            if row in X_PER_GEOMETRY:
                phase("xpass_geometry", kernel=row, shape=list(sig[1]),
                      co=sig[2], act=sig[3], dil=sig[4], next_bn=sig[6],
                      moments=sig[7],
                      ms=round(t[0], 4), product_ms=round(t[3], 4),
                      bound_ms=round(max(bb, bo), 5),
                      bound_by="bytes" if bb >= bo else "operations",
                      per_step_calls=cnt, card=card)
            del seq, lib
        del args
    for row, (t_ker, t_ref, t_stock, t_lib, bb, bo) in rows.items():
        total[row, torch.bfloat16] = (t_ker, t_ref)
        bound[row] = [max(bb, bo), bb, bo]
        stock[row], product[row] = t_stock, t_lib
        extra = {"partial_mb": round(parts[row][0], 2),
                 "reduce_ms": round(parts[row][1], 4)}
        if row in hosts:
            extra["host_us"] = round(hosts[row][0] / hosts[row][1], 2)
        phase("xpass_time", kernel=row, ms=round(t_ker, 4),
              plain_ms=round(t_ref, 4), stock_ms=round(t_stock, 4),
              product_ms=round(t_lib, 4), bound_ms=round(max(bb, bo), 5),
              bound_by="bytes" if bb >= bo else "operations",
              per_step_launches=X_PASSES[row][2], **extra, card=card)


def x8_d4_time(g, sigs, total, bound, stock, product, card):
    """Phase x8_d4_time: the dilation-4 instances (X_D4) over their calls in
    one OS8 step (bf16, each distinct geometry weighted by its calls): the
    kernel against its plain version by CUDA events in turns (paired_ms;
    late in this run the profiler drops launches, PERF.md), the stock
    sequence it replaces and the one PyTorch call computing its conv alone
    (F.conv2d, aten.convolution_backward) by CUDA events, and its bound
    (x_pass_bound_ms); a line per geometry (phase x8_d4_geometry) with the
    forward's plan (CTAs along x, slice, tile rows) or the backward's
    grid."""
    from kd_cheap_conv_tpu_torch.ops import stem as tst

    counts = {}
    for sig in sigs:
        if sig[0] in ("dw", "dw_bwd") and sig[4] == 4:
            counts[sig] = counts.get(sig, 0) + 1
    rows = {}
    for sig, cnt in counts.items():
        args = x_pass_args(sig, torch.bfloat16, g)
        row = X_ROWS[sig[0]][0]
        key = f"{row}_d4"
        kernel, plain = x_pass_fns(row, sig)
        seq, lib = x_pass_stock(row, sig, args)
        t_ker, t_ref = paired_ms(lambda: kernel(*args), lambda: plain(*args),
                                 reps=3)
        t_seq, t_lib = cuda_ms(seq, iters=10), cuda_ms(lib, iters=10)
        bb, bo = x_pass_bound_ms(row, sig)
        r = rows.setdefault(key, [0.0] * 6 + [0])
        for i, v in enumerate((t_ker, t_ref, t_seq, t_lib, bb, bo, 1)):
            r[i] += cnt * v
        n, h, w, c = sig[1]
        if sig[0] == "dw":
            pl = tst.bn_dw_fwd_plan(n, h, w, c, 1, 4, 2)
            plan = {"ctas_x": pl.grid, "slice": pl.cs, "tile_rows": pl.th,
                    "slices": c // pl.cs}
        else:
            plan = {"ctas_x": tst.dw_bwd_grid(torch.bfloat16, n, h, w, c, 1,
                                              4)}
        phase("x8_d4_geometry", kernel=key, shape=list(sig[1]), co=sig[2],
              act=sig[3], bn=sig[5], ms=round(t_ker, 4),
              plain_ms=round(t_ref, 4), stock_ms=round(t_seq, 4),
              product_ms=round(t_lib, 4), bound_ms=round(max(bb, bo), 5),
              bound_by="bytes" if bb >= bo else "operations",
              per_step_calls=cnt, plan=plan, card=card)
        del args, seq, lib
    if set(rows) != {f"{row}_d4" for row in X_D4}:
        raise SystemExit(f"x8_d4_time: the OS8 step's dilation-4 calls gave "
                         f"rows {sorted(rows)}")
    for key, (t_ker, t_ref, t_seq, t_lib, bb, bo, calls) in rows.items():
        total[key, torch.bfloat16] = (t_ker, t_ref)
        bound[key] = [max(bb, bo), bb, bo]
        stock[key], product[key] = t_seq, t_lib
        phase("x8_d4_time", kernel=key, timing="CUDA events, in turns with "
              "the plain version", ms=round(t_ker, 4),
              plain_ms=round(t_ref, 4), stock_ms=round(t_seq, 4),
              product_ms=round(t_lib, 4), bound_ms=round(max(bb, bo), 5),
              bound_by="bytes" if bb >= bo else "operations",
              per_step_launches=calls, card=card)


def xeval_bound_ms(sigs, esize=2):
    """Least time on the card of the functions the kernel replaces, summed
    over one eval forward, as (ms, bytes ms, operations ms). The function
    is the JAX kernels' (`_k_block_eval`, `_k_seg_eval`): a whole block or
    exit segment, three consecutive calls of `sigs`, which keeps its
    intermediates on chip. So per function: its input and output once in
    the activation dtype (the residual or skip reads the input), the folded
    weights, taps and biases once; the 1x1 products over the bf16
    tensor-core peak and the depthwise taps' f32 FMAs over the f32 peak,
    the larger of the two (they run on separate units); the function's
    bound the larger of bytes and operations."""
    if len(sigs) % 3:
        raise SystemExit(f"xeval_bound_ms: {len(sigs)} calls are not whole "
                         f"blocks")
    tot = [0.0, 0.0, 0.0]
    for g in range(0, len(sigs), 3):
        seg = sigs[g:g + 3]
        n, h, w, c_in = seg[0][0]
        p = n * h * w
        nbytes = esize * p * (c_in + seg[-1][1])
        tc = fma = 0.0
        for shape, co, _, _, _, res, _, _ in seg:
            ci = shape[3]
            cs = res if res not in (None, "x0") else 0
            nbytes += esize * co * (ci + cs) + 4 * (9 * ci + co + (cs > 0) * co)
            tc += 2 * p * co * (ci + cs)
            fma += 18 * p * ci
        b_ms = nbytes / HBM_BPS * 1e3
        o_ms = max(tc / BF16_FLOPS, fma / F32_FLOPS) * 1e3
        for i, v in enumerate((max(b_ms, o_ms), b_ms, o_ms)):
            tot[i] += v
    return tuple(tot)


def kernel_events_ms(fn, names, iters=3, rounds=3):
    """Device ms per call of fn of the kernels whose name holds each of
    `names` (torch.profiler), the median of `rounds` rounds of `iters`
    calls: {name: ms}."""
    fn()
    runs = {nm: [] for nm in names}
    for _ in range(rounds):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for nm in names:
            runs[nm].append(sum(e.device_time_total
                                for e in prof.key_averages()
                                if e.device_type == DeviceType.CUDA
                                and nm in e.key) / iters / 1e3)
    return {nm: statistics.median(v) for nm, v in runs.items()}


def xsep_kernel_bound_ms(sig, esize=2):
    """Least time of each of the bf16 sep conv's two kernels at one
    geometry, as {kernel: (bytes ms, operations ms)}: the depthwise pass
    reads x (f32 or bf16) and the taps and writes t (bf16) once, its taps'
    f32 FMAs over the f32 peak; the product reads t, W, the biases and the
    residual or skip input once and writes y (f32 or bf16), its products
    over the bf16 tensor-core peak; and of the f32 kernel (the whole sep
    conv in f32, its products on the f32 FMA peak)."""
    shape, co, _, _, _, res, in32, out32 = sig
    n, h, w, ci = shape
    p = n * h * w
    cs = res if res not in (None, "x0") else 0
    dw_bytes = p * ci * ((4 if in32 else esize) + esize) + 36 * ci
    mm_bytes = (esize * (p * ci + co * ci + cs * (p + co))
                + (esize * p * co if res == "x0" else 0)
                + p * co * (4 if out32 else esize) + 8 * co)
    f32_bytes = 4 * (p * ci + 9 * ci + co * ci + cs * (p + co) + 2 * co
                     + p * co * (2 if res == "x0" else 1))
    products = 2 * p * co * (ci + cs)
    return {"xsep_dw": (dw_bytes / HBM_BPS * 1e3, 18 * p * ci / F32_FLOPS * 1e3),
            "xsep_mm": (mm_bytes / HBM_BPS * 1e3, products / BF16_FLOPS * 1e3),
            "xsep_eval": (f32_bytes / HBM_BPS * 1e3,
                          (products + 18 * p * ci) / F32_FLOPS * 1e3)}


def xeval_time(g, sigs, total, bound, product, card):
    """Phase xeval_time: the bf16 folded sep conv's two kernels, the
    depthwise pass and the product, over the 54 sep convs of one config-#3
    teacher forward. Their device time three ways: `ms`, on the path,
    their launches inside profiled teacher forwards (what the forward pays;
    the kernels line's figures), each kernel and the pair's sum;
    `isolated_ms`, each distinct geometry timed alone on repeated calls
    with the same inputs (warm L2) and weighted by its calls; `cold_ms`,
    the same with a 256 MB write between calls (cold L2). Beside them, per
    kernel, its plain version, the one PyTorch call computing its product
    or conv alone (product_ms: torch.matmul of the 1x1 products, the
    skip's too; F.conv2d of the depthwise conv, groups = C), summed as
    isolated_ms, and its bound (xsep_kernel_bound_ms); for the pair, the
    bound of the blocks and segments it replaces (xeval_bound_ms) and the
    stock sequence it replaces (the teacher's middle- and exit-flow modules
    on cuDNN, eval BN, relu, add, from the block3 output); then the
    teacher's whole forward with the eval chains on and off (CUDA events,
    in turns, each reading kept; phase xteacher_time). The f32 kernel
    (parity only) is timed alone at the same geometries in f32."""
    import torch.nn.functional as F
    from kd_cheap_conv_tpu_torch.ops import xchain_eval as xe

    names = {k: XEVAL[k][1] for k in ("xsep_dw", "xsep_mm")}
    counts = {}
    for sig in sigs:
        counts[sig] = counts.get(sig, 0) + 1
    flush = torch.empty(2 ** 26, device="cuda")   # 256 MB, past the L2
    acc = {k: [0.0] * 6 for k in (*names, "xsep_eval")}
    for sig, cnt in counts.items():
        args, kw = xeval_args(sig, torch.bfloat16, g)
        x, taps, w, b = args
        ci = sig[0][3]
        rest = {k: v for k, v in kw.items() if k not in ("dil", "pre_relu")}
        dw = {"dil": kw["dil"], "pre_relu": kw["pre_relu"]}
        t = xe.run_xsep_dw(x, taps, **dw)
        a2, xn = t.reshape(-1, ci), x.permute(0, 3, 1, 2)
        kc = taps.t().reshape(ci, 1, 3, 3).to(x.dtype)
        if sig[5] in (None, "x0"):
            def mm_lib():
                return torch.matmul(a2, w.t())
        else:
            x0, wsk = kw["x0"].reshape(-1, sig[5]), kw["wsk"]

            def mm_lib():
                return torch.matmul(a2, w.t()), torch.matmul(x0, wsk.t())

        def dw_lib():
            return F.conv2d(xn, kc, None, 1, kw["dil"], kw["dil"], ci)

        def cold():
            flush.fill_(0.0)
            xe.run_xsep_eval(*args, **kw)

        cold_ms = kernel_events_ms(cold, list(names.values()))
        bounds = xsep_kernel_bound_ms(sig)
        row = {"xsep_dw": (x_dev_ms(lambda: xe.run_xsep_dw(x, taps, **dw)),
                           cold_ms[names["xsep_dw"]],
                           x_dev_ms(lambda: xe.xsep_dw_ref(x, taps, **dw)),
                           x_dev_ms(dw_lib)),
               "xsep_mm": (x_dev_ms(lambda: xe.run_xsep_mm(t, w, b, **rest)),
                           cold_ms[names["xsep_mm"]],
                           x_dev_ms(lambda: xe.xsep_mm_ref(t, w, b, **rest)),
                           x_dev_ms(mm_lib))}
        for k, vals in row.items():
            for i, v in enumerate((*vals, *bounds[k])):
                acc[k][i] += cnt * v
        args32, kw32 = xeval_args(sig, torch.float32, g)
        f32_ms = x_dev_ms(lambda: xe.run_xsep_eval(*args32, **kw32))
        f32_ref = x_dev_ms(lambda: xe.xsep_eval_ref(*args32, **kw32))
        acc["xsep_eval"][0] += cnt * f32_ms
        acc["xsep_eval"][2] += cnt * f32_ref
        phase("xeval_time", shape=list(sig[0]), co=sig[1], dilation=sig[2],
              residual=sig[5], in_f32=sig[6], out_f32=sig[7], calls=cnt,
              **{f"{k}_{m}": round(v, 4) for k, vals in row.items()
                 for m, v in zip(("isolated_ms", "cold_ms", "plain_ms",
                                  "product_ms"), vals)},
              f32_kernel_ms=round(f32_ms, 4), f32_plain_ms=round(f32_ref, 4))
        del args, kw, args32, kw32, t, a2, xn
    del flush
    teacher = x_calibrated(torch.bfloat16)
    tb = teacher.backbone
    n, h, w, c = next(sg[0] for sg in sigs if sg[5] == "x0")
    y0 = torch.randn((n, c, h, w), device="cuda", generator=g).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def stock_flows():
        y = y0
        for b in tb.middle:
            y = b(y)
        y = tb.exit_block(y)
        return tb.exit_sep3(tb.exit_sep2(tb.exit_sep1(y)))

    with torch.no_grad():
        t_stock = device_ms_all(stock_flows, iters=3)
    images = x_batch()[0]

    def forward():
        with torch.no_grad():
            teacher(images, class_major=True, upsample=False)

    t_path = kernel_events_ms(forward, list(names.values()))
    b_ms, bb, bo = xeval_bound_ms(sigs)
    for k, name in names.items():
        iso, cold_k, ref, lib, kb, ko = acc[k]
        total[k, torch.bfloat16] = (t_path[name], ref)
        bound[k] = [max(kb, ko), kb, ko]
        product[k] = lib
        phase("xeval_time", kernel=name, what="its 54 launches in one "
              "config-#3 teacher forward", ms=round(t_path[name], 4),
              isolated_ms=round(iso, 4), cold_ms=round(cold_k, 4),
              plain_ms=round(ref, 4), product_ms=round(lib, 4),
              bound_ms=round(max(kb, ko), 5),
              bound_by="bytes" if kb >= ko else "operations",
              per_forward_launches=XEVAL[k][2], card=card)
    pair = sum(t_path.values())
    # the f32 kernel, timed alone at the forward's geometries in f32
    total["xsep_eval", torch.bfloat16] = (acc["xsep_eval"][0],
                                          acc["xsep_eval"][2])
    f32_bytes = sum(xsep_kernel_bound_ms(sg)["xsep_eval"][0] for sg in sigs)
    f32_ops = sum(xsep_kernel_bound_ms(sg)["xsep_eval"][1] for sg in sigs)
    bound["xsep_eval"] = [max(f32_bytes, f32_ops), f32_bytes, f32_ops]
    phase("xeval_time", what="the 54 folded sep convs of one config-#3 "
          "teacher forward, the two kernels' launches summed",
          ms=round(pair, 4), dw_ms=round(t_path[names["xsep_dw"]], 4),
          mm_ms=round(t_path[names["xsep_mm"]], 4),
          isolated_ms=round(acc["xsep_dw"][0] + acc["xsep_mm"][0], 4),
          cold_ms=round(acc["xsep_dw"][1] + acc["xsep_mm"][1], 4),
          stock_ms=round(t_stock, 4), bound_ms=round(b_ms, 5),
          bound_bytes_ms=round(bb, 5), bound_ops_ms=round(bo, 5),
          bound_by="bytes" if bb >= bo else "operations",
          f32_kernel_ms=round(acc["xsep_eval"][0], 4),
          f32_plain_ms=round(acc["xsep_eval"][2], 4),
          per_forward_launches={XEVAL[k][1]: XEVAL[k][2] for k in names},
          card=card)

    def forward_modules():
        tb._fused_entry_eval_ok = lambda blk: False
        tb._fused_middle_eval_active = lambda: False
        tb._fused_tail_eval_active = lambda: False
        try:
            forward()
        finally:
            del (tb._fused_entry_eval_ok, tb._fused_middle_eval_active,
                 tb._fused_tail_eval_active)

    readings = [paired_ms(forward, forward_modules, reps=3)
                for _ in range(3)]
    phase("xteacher_time", what=f"config-#3 teacher forward ({X_MODEL}, "
          f"eval, no_grad), {X_CROP}², batch {X_BATCH}, bf16",
          eval_chains_ms=round(statistics.median(r[0] for r in readings), 3),
          modules_ms=round(statistics.median(r[1] for r in readings), 3),
          readings=[[round(a, 3), round(b, 3)] for a, b in readings],
          card=card)
    del teacher, y0, images


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


def port_kernels():
    """Every launch counter of the port's kernels, by the name the phases
    and the kernels line use: a wrapper, or a kernel instance's count
    (DilationCount)."""
    from kd_cheap_conv_tpu_torch.ops import decoder as tdec
    from kd_cheap_conv_tpu_torch.ops import dwconv as tdw
    from kd_cheap_conv_tpu_torch.ops import irchain_eval as ire
    from kd_cheap_conv_tpu_torch.ops import losses_fused as lf
    from kd_cheap_conv_tpu_torch.ops import rchain as trc
    from kd_cheap_conv_tpu_torch.ops import separable as tsep
    from kd_cheap_conv_tpu_torch.ops import stem as tst
    from kd_cheap_conv_tpu_torch.ops import tstem as tts
    from kd_cheap_conv_tpu_torch.ops import upsample as tup
    from kd_cheap_conv_tpu_torch.ops import xchain_eval as xe

    return {"A": ire.fused_mnv2_blocks_eval, "B": ire.fused_ir_block_s2_eval,
            "C": lf.ce_kl_upsampled_fwd, "D": lf.ce_kl_upsampled_bwd,
            **{k: getattr(tst, f"run_{k}") for k in PASSES},
            **{k: getattr(tst, f"run_{k}") for k in ENTRY if k != "tstem"},
            "tstem": tts.fused_stem_pool_eval, "sep": tsep.run_separable,
            **{k: getattr(tdec, f"run_{k}") for k in HEAD_KERNELS
               if k != "sep"},
            "up_fwd": tup.run_up_fwd, "up_bwd": tup.run_up_bwd,
            "dw_conv": tdw.run_dw_conv, "dw_dx": tdw.run_dw_dx,
            "dw_dk": tdw.run_dw_dk, "bneck": trc.run_bneck_eval,
            "ce_kl_fwd": lf.ce_kl_fwd, "ce_kl_bwd": lf.ce_kl_bwd,
            **{k: getattr(tst, v[0]) for k, v in X_PASSES.items()
               if v[3] == XPW_SRC},
            **{k: getattr(xe, v[0]) for k, v in XEVAL.items()},
            **{f"{row}_d4": DilationCount(getattr(tst, X_PASSES[row][0]), 4)
               for row in X_D4}}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from kd_cheap_conv_tpu_torch import native
    from kd_cheap_conv_tpu_torch.ops import decoder as tdec
    from kd_cheap_conv_tpu_torch.ops import dwconv as tdw
    from kd_cheap_conv_tpu_torch.ops import irchain_eval as ire
    from kd_cheap_conv_tpu_torch.ops import losses_fused as lf
    from kd_cheap_conv_tpu_torch.ops import rchain as trc
    from kd_cheap_conv_tpu_torch.ops import separable as tsep
    from kd_cheap_conv_tpu_torch.ops import stem as tst
    from kd_cheap_conv_tpu_torch.ops import tstem as tts
    from kd_cheap_conv_tpu_torch.ops import upsample as tup
    from kd_cheap_conv_tpu_torch.ops import xchain_eval as xe

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi("name,power.limit")
    sm_clock = float(smi("clocks.max.sm", "csv,noheader,nounits"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kernels = port_kernels()

    def launches_of():
        return {k: fn.launches for k, fn in kernels.items()}

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
                out = launch[k](x, f)
                again = launch[k](x, f)
                want = refs[k](x, f).float()
            torch.cuda.synchronize()
            got = out.float()
            err = (got - want).abs()
            twice = bool(torch.equal(out, again))
            ok = bool((err <= atol + rtol * want.abs()).all()) and twice
            worst[k, dtype] = max(worst[k, dtype], float(err.max()))
            phase("parity", kernel=k, block=f"f{i}", shape=list(shape),
                  dtype=str(dtype)[6:], max_abs_err=float(err.max()),
                  rtol=rtol, atol=atol, bit_identical_twice=twice, ok=ok)
            if not ok:
                raise SystemExit(f"parity failed: kernel {k} on f{i} {dtype}"
                                 f"{'' if twice else ' (two calls differ)'}")
    n_a = sum(ire.ir_block_fusable(f) for _, f, _ in blocks)
    n_b = sum(ire.ir_block_s2_fusable(f) for _, f, _ in blocks)
    if (n_a, n_b) != (14, 3):
        raise SystemExit(f"expected 14 stride-1 and 3 stride-2 blocks, "
                         f"got {n_a} and {n_b}")

    # 3. kernels C and D against their plain versions at config #2's shape
    loss_args = LOSS_GEO["args"]
    loss_parity(g, worst)

    # 4. the pass kernels, at every geometry, the entry kernels, then the
    # whole chains from the image
    chain_parity(g, worst)
    entry_parity(g, worst)
    features_parity()
    head_parity(g, worst)
    head_module_parity()
    geos = dw_geometries()
    resample_dw_parity(g, worst, geos)
    rchain_parity(worst, launches_of)
    cached_loss_parity(g, worst)
    x_sigs, x_geo = x_step_geometries()
    head_parity(g, worst, x_geo["head"])
    loss_parity(g, worst, x_geo["loss"])
    resample_dw_parity(g, worst, x_geo["dw"], x_geo["ups"])
    xpass_parity(g, worst, x_sigs)
    xception_parity()
    xeval_parity(g, worst, x_geo["xsep"])
    xception_eval_parity(kernels)
    x8_sigs, x8_geo = x_step_geometries(8)
    x8_parity(g, worst, x8_sigs, x8_geo, x_sigs, x_geo)

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
        if got != {**{k: 0 for k in kernels}, "A": 14 * fwd, "B": 3 * fwd,
                   "sep": 4 * fwd, "up_fwd": fwd}:
            raise SystemExit(f"expected {14 * fwd} A, {3 * fwd} B, "
                             f"{4 * fwd} separable and {fwd} up_fwd launches "
                             f"and no pass, entry, decoder, up_bwd, "
                             f"depthwise, bottleneck or full-resolution loss "
                             f"launch, got {got}")
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
    agree = share_of(fused.argmax(1) == plain.argmax(1))
    phase("logits", shape=list(fused.shape), max_abs_err=err,
          max_abs_logit=scale, argmax_agree=agree,
          plain_path_launches=in_plain)
    if not (torch.isfinite(fused).all() and err <= 1e-3 * max(1.0, scale)
            and agree >= 0.999 and not in_plain):
        raise SystemExit("full-model logits: kernel path and plain path "
                         f"disagree (plain path launched {in_plain})")
    del model, fused, plain
    main_x(kernels, card)
    main_x(kernels, card, 8)

    # 6. the training path (config #2 KD, 4 steps), counted from zero
    from kd_cheap_conv_tpu_torch import main as port_main

    with tempfile.TemporaryDirectory() as ckpt_dir:
        for fn in kernels.values():
            fn.launches = 0
        tdw.depthwise_conv2d.layout_copies = 0
        trc.run_bneck_eval.layout_copies = 0
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
          depthwise_layout_copies=tdw.depthwise_conv2d.layout_copies,
          bottleneck_layout_copies=trc.run_bneck_eval.layout_copies)
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
    if (got["bneck"] != BNECK[1] * TRAIN_STEPS or got["ce_kl_fwd"]
            or got["ce_kl_bwd"] or trc.run_bneck_eval.layout_copies):
        raise SystemExit(f"train: expected {BNECK[1]} bottleneck launches "
                         f"per step on the teacher's NHWC memory (no layout "
                         f"copy) and no full-resolution loss launch, got "
                         f"{got}, {trc.run_bneck_eval.layout_copies} copies")
    if any(got[k] for k in ("xpw_fwd", "xpw_dgrad", "xpw_wgrad")):
        raise SystemExit(f"train: the MobileNetV2 chains ran a wide 1x1 "
                         f"kernel: {got}")
    if latest not in ckpts:
        raise SystemExit(f"train: no {latest} in {ckpts}")
    for k in ("C", "D", *PASSES, *ENTRY, *HEAD_KERNELS, *RESAMPLE_KERNELS,
              "bneck"):
        launches[k] = got[k]

    # 6b. config #3 (Xception-65 at 769²), counted from zero
    x_launches = train_x(kernels, card)
    for row, k in X_COUNTER.items():
        launches[row] = x_launches[k]
    for k in XEVAL:
        launches[k] = x_launches[k]
    # and at OS8: the dilation-4 instances' launches
    x8_launches = train_x(kernels, card, 8)
    for row in X_D4:
        launches[f"{row}_d4"] = x8_launches[f"{row}_d4"]

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

    def teacher_forward_module_bnecks():
        tb._bneck_eval_active = lambda blk: False
        try:
            teacher_forward()
        finally:
            del tb._bneck_eval_active

    t_stem, t_mod = paired_ms(teacher_forward, teacher_forward_modules,
                              reps=3)
    t_bneck, t_bmod = paired_ms(teacher_forward,
                                teacher_forward_module_bnecks, reps=3)
    phase("teacher_time", what="teacher forward (ResNet-101 DeepLabV3+, "
          "eval, no_grad), 513², batch 16, bf16", stem_kernel_ms=round(
              t_stem, 3), module_stem_ms=round(t_mod, 3),
          bneck_kernel_ms=round(t_bneck, 3),
          module_bnecks_ms=round(t_bmod, 3), card=card)
    x_step, x_med = x_rate(card)
    x8_step, x8_med = x_rate(card, 8)

    # config #1: the cache build and the cached step, counted from zero
    cached_launches = cached_path(kernels, card)
    for k in FULL_LOSS:
        launches[k] = cached_launches[k]

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
        # C's and D's wrappers' host time per call (host_us)
        extra = {"host_us": round(host_us(kfn), 2)} if inst == "kl" else {}
        if inst == "kl":                  # the KD step's instance
            total[k, torch.bfloat16] = (t_ker, t_ref)
            bound[k] = [b_ms] + ([1.0, 0.0] if b_by == "bytes"
                                 else [0.0, 1.0])
        phase("loss_time", at="config #2", kernel=k, instance=inst,
              shape=list(s.shape), out=[CROP, CROP], dtype="bfloat16",
              ms=round(t_ker, 4), plain_ms=round(t_ref, 4),
              wall_ms=round(w_ker, 4), plain_wall_ms=round(w_ref, 4),
              bound_ms=round(b_ms, 5), bound_by=b_by,
              sm_clock_max_mhz=sm_clock, **extra, card=card)
    del s, t, lbl
    # and at config #3's geometry (4 x 19 x 193² -> 769²), the KL instance
    # the step runs, a teacher spanning +-1e5; reported, not in the line
    geo3 = x_geo["loss"]
    s, t, lbl = loss_inputs(torch.bfloat16, g, geo3)
    scales = loss_scales(lbl, geo3["args"][2])
    for k, kfn, pfn in (
            ("C", lambda: lf.ce_kl_upsampled_fwd(s, t, lbl, *geo3["args"]),
             lambda: lf.ce_kl_upsampled_fwd_ref(s, t, lbl, *geo3["args"])),
            ("D", lambda: lf.ce_kl_upsampled_bwd(s, t, lbl, scales,
                                                 *geo3["args"]),
             lambda: lf.ce_kl_upsampled_bwd_ref(s, t, lbl, scales,
                                                *geo3["args"]))):
        t_ker, t_ref = device_ms(kfn, pfn, name=LOSS_KERNELS[k], iters=5)
        b_ms, b_by = loss_bound_ms(k, s, t, lbl, sm_clock, sms)
        phase("loss_time", at=geo3["at"], kernel=k, instance="kl",
              shape=list(s.shape), out=list(geo3["args"][:2]),
              dtype="bfloat16", ms=round(t_ker, 4), plain_ms=round(t_ref, 4),
              bound_ms=round(b_ms, 5), bound_by=b_by,
              sm_clock_max_mhz=sm_clock, host_us=round(host_us(kfn), 2),
              card=card)
    del s, t, lbl
    # the pass kernels at each geometry (bf16), the entry kernels, and
    # features[0..6]
    stock, product = {}, {}
    pass_times(g, total, bound, stock, product, card)
    entry_times(g, total, bound, stock, card)
    features_times(card)
    head_times(g, total, bound, stock, card, x_geo["head"])
    library = {}
    resample_dw_times(g, geos, total, bound, stock, library, card,
                      x_geo["dw"])
    rchain_times(kd_teacher, t_images, total, bound, stock, card)
    cached_loss_times(g, total, bound, stock, sm_clock, sms, card)
    xpass_time(g, x_sigs, total, bound, stock, product, card)
    xeval_time(g, x_geo["xsep"], total, bound, product, card)
    x8_d4_time(g, x8_sigs, total, bound, stock, product, card)

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
            {ENTRY["tstem"][0]: 1, RESAMPLE_KERNELS["up_fwd"][0]: 1,
             BNECK[0]: BNECK[1]})
    head_by_kernel = {}
    step_split, top_other, s_rounds = device_split(
        lambda: kd_step(t_images, t_labels), step_kernel_launches(),
        head=head_by_kernel)
    step_busy = sum(step_split.values())
    kd_split = {"loss_CD": step_split["loss_CD"],
                "teacher_chain": step_split["teacher_chain"],
                "teacher_convs": teacher_split["convs"],
                "student_convs": step_split["convs"] - teacher_split["convs"],
                "bn_passes": step_split["bn_passes"],
                "entry": step_split["entry"], "head": step_split["head"],
                "resample_dw": step_split["resample_dw"],
                "bn": step_split["bn"], "other": step_split["other"]}
    phase("train_profile", what="one KD step, 513², batch 16, bf16",
          device_ms={k: round(v, 3) for k, v in kd_split.items()},
          head_ms_by_kernel=head_by_kernel,
          teacher_forward_ms={k: round(v, 3)
                              for k, v in teacher_split.items()},
          top_other=top_other, profiled_rounds={"teacher": t_rounds,
                                                "step": s_rounds},
          device_busy_ms=round(step_busy, 3),
          untraced_step_ms=round(smed, 3),
          device_idle_share=round(1 - step_busy / smed, 3)
          if step_busy else None, card=card)
    x_profile(x_step, x_med, card)
    x_profile(x8_step, x8_med, card, 8)
    del x_step, x8_step

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
                  for k, v in RESAMPLE_KERNELS.items()},
               "bneck": ("fused_resnet_blocks_eval, fused_resnet_stage_eval_"
                         f"hwnc ({BNECK[0]})", RCHAIN_SRC, BNECK[2]),
               **{k: (f"fused_ce_kl_loss, {way} ({FULL_LOSS[k][0]})",
                      CEKL_SRC, FULL_LOSS[k][2])
                  for k, way in (("ce_kl_fwd", "forward"),
                                 ("ce_kl_bwd", "backward"))},
               **{k: (f"{k} ({v[1]}, config #3)", v[3], v[4])
                  for k, v in X_PASSES.items()},
               **{f"{r}_d4": (f"{r}_d4 ({X_PASSES[r][1]}<T, 1, 4>, config "
                              f"#3 at OS8's exit flow)", PASS_SRC,
                              X_PASSES[r][4])
                  for r in X_D4},
               **{k: (f"fused_x_middle_eval, fused_x_tail_eval ({v[1]}, "
                      + {"xsep_dw": "the bf16 sep conv's depthwise pass",
                         "xsep_mm": "the bf16 sep conv's TMA + wgmma product",
                         "xsep_eval": "the f32 sep conv, parity only"}[k]
                      + ")", XEVAL_SRC, XEVAL_WHERE)
                  for k, v in XEVAL.items()}}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": where,
         "launches": launches[k],
         "max_abs_err": worst.get((k, torch.float32),
                                  worst.get((k, torch.bfloat16))),
         "max_abs_err_bf16": worst.get((k, torch.bfloat16)),
         "ms": round(total[k, torch.bfloat16][0], 4),
         "plain_ms": round(total[k, torch.bfloat16][1], 4),
         "bound_ms": round(bound[k][0], 5),
         "bound_by": "bytes" if bound[k][1] >= bound[k][2] else "operations",
         "library_ms": (round(library[k], 4) if k in library else None),
         **({"product_ms": round(product[k], 4)} if k in product else {}),
         **({"stock_ms": round(stock[k], 4)} if k in stock else {})}
        for k, (name, src, where) in entries.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
