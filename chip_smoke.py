#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on a CUDA card.

    python3 chip_smoke.py

Drives kd_cheap_conv_tpu_torch (never JAX) on one card, in phases; each
prints its result, and any failure exits non-zero:

1. build   — compile the CUDA kernels from csrc/ (nvcc, sm_90a).
2. parity  — kernel A (stride-1 eval IR block) and kernel B (stride-2) on
             all 17 block geometries of the 513² student at OS16, batch 4,
             against their plain PyTorch versions, in f32 (TF32 off) and
             bf16.
3. main    — the serving entry point, `kd_cheap_conv_tpu_torch.main.main`,
             plain validate and multi-scale + flip TTA at 513² in bf16:
             a finite mIoU, and exactly 14 kernel-A and 3 kernel-B launches
             per student forward. Then full-model logits with the kernels
             against the plain path (the same model with autograd on, where
             every block runs its own module) in f32, TF32 off.
4. times   — validate images/s at 513² in bf16 on device-resident
             batches, untraced; each block's kernel against its plain
             version at 513², batch 4: device time (torch.profiler, kernels
             only) and wall time per call (CUDA events, host launch gaps
             included); one profiled validate pass split by kernel, with
             the device's idle share. Printed beside the card's name and
             power limit.

The line before the last is the card's `nvidia-smi` name and power limit;
the last line is {"ok": true, "device": {...}}. Without a CUDA card, or
without the rest of the repository beside it, it exits non-zero and prints
no result.
"""

import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

MAIN_ARGS = ["--test_only", "--dataset", "synthetic", "--model",
             "deeplabv3plus_mobilenet", "--kd", "--replace_scope",
             "classifier", "--crop_size", "513", "--val_batch_size", "4",
             "--bf16"]
TTA_SCALES = "0.5,1.0,1.5"
N_VAL, BATCH, CROP = 32, 4, 513
# f32: both sides sum ~1000-term products in different orders (and the
# kernel folds the BNs first); bf16: the plain path rounds every
# intermediate to bf16, the kernel keeps the expand and dw sums in f32.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 1e-1)}
SRC = "kd_cheap_conv_tpu_torch/csrc/ir_block_eval.cu"
KERNEL_NAME = "ir_block_eval_kernel"


def phase(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def student(dtype=None, seed=1):
    """The student as main builds it, with random BN statistics (so the
    folds are not near-identity), in eval mode on the card."""
    from kd_cheap_conv_tpu_torch.kd.replace import (CheapConvSpec,
                                                    replace_cheap_convs)
    from kd_cheap_conv_tpu_torch.models import build_model

    g = torch.Generator().manual_seed(seed)
    m = build_model("deeplabv3plus_mobilenet", 21, 16, dtype=dtype,
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


def cuda_ms(fn, iters=20):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(kernel, plain, iters=10, rounds=3):
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
                if KERNEL_NAME in e.key:
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from kd_cheap_conv_tpu_torch import native
    from kd_cheap_conv_tpu_torch.ops import irchain_eval as ire

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = {"A": ire.fused_mnv2_blocks_eval, "B": ire.fused_ir_block_s2_eval}
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
    worst = {("A", torch.float32): 0.0, ("B", torch.float32): 0.0,
             ("A", torch.bfloat16): 0.0, ("B", torch.bfloat16): 0.0}
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

    # 3. the main path, counted from zero
    forwards = math.ceil(N_VAL / BATCH)
    launches = {"A": 0, "B": 0}
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
        if got != {"A": 14 * fwd, "B": 3 * fwd}:
            raise SystemExit(f"expected {14 * fwd} A and {3 * fwd} B "
                             f"launches, got {got}")
        for k in launches:
            launches[k] += got[k]

    from kd_cheap_conv_tpu_torch.data import SyntheticSegmentation

    val = SyntheticSegmentation(21, size=CROP, length=N_VAL, seed=2)
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

    # 4. times: validate first, untraced and before any torch.profiler
    # session (one such session slowed later passes by ~4% on an H100 host)
    from kd_cheap_conv_tpu_torch.train.loop import validate

    bf16_model = student(torch.bfloat16)
    batches = []
    for s in range(0, N_VAL, BATCH):
        im, lb = zip(*(val[i] for i in range(s, s + BATCH)))
        batches.append((torch.from_numpy(np.stack(im)).float().cuda()
                        .permute(0, 3, 1, 2),
                        torch.from_numpy(np.stack(lb)).long().cuda()))
    validate(bf16_model, batches, num_classes=21)            # warm-up
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        validate(bf16_model, batches, num_classes=21)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = statistics.quantiles(walls, n=4)
    phase("validate_rate", images=N_VAL, batch=BATCH, dtype="bfloat16",
          passes=len(walls), median_img_per_s=round(N_VAL / med * 1e3, 2),
          q1_img_per_s=round(N_VAL / q3 * 1e3, 2),
          q3_img_per_s=round(N_VAL / q1 * 1e3, 2),
          median_pass_ms=round(med, 3),
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 2**30, 2))

    # per block, bf16 (the serving dtype) and f32
    total = {}
    for dtype in (torch.bfloat16, torch.float32):
        for i, f, shape in blocks:
            k = "A" if ire.ir_block_fusable(f) else "B"
            x = torch.randn(shape, device="cuda", generator=g).to(dtype)
            with torch.no_grad():
                kfn, pfn = (lambda: launch[k](x, f)), (lambda: refs[k](x, f))
                w_ker, w_ref = paired_ms(kfn, pfn)
                t_ker, t_ref = device_ms(kfn, pfn)
            phase("block_time", kernel=k, block=f"f{i}", dtype=str(dtype)[6:],
                  ms=round(t_ker, 4), plain_ms=round(t_ref, 4),
                  wall_ms=round(w_ker, 4), plain_wall_ms=round(w_ref, 4))
            tk, tr = total.get((k, dtype), (0.0, 0.0))
            total[k, dtype] = (tk + t_ker, tr + t_ref)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        validate(bf16_model, batches, num_classes=21)
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

    print(json.dumps({"kernels": [
        {"name": "fused_mnv2_blocks_eval", "route": "cuda", "source": SRC,
         "replaces": "kd_cheap_conv_tpu/ops/pallas/irchain.py:548",
         "launches": launches["A"],
         "max_abs_err": worst["A", torch.float32],
         "max_abs_err_bf16": worst["A", torch.bfloat16],
         "ms": round(total["A", torch.bfloat16][0], 4),
         "plain_ms": round(total["A", torch.bfloat16][1], 4)},
        {"name": "fused_ir_block_s2_eval", "route": "cuda", "source": SRC,
         "replaces": "kd_cheap_conv_tpu/ops/pallas/irchain.py:586",
         "launches": launches["B"],
         "max_abs_err": worst["B", torch.float32],
         "max_abs_err_bf16": worst["B", torch.bfloat16],
         "ms": round(total["B", torch.bfloat16][0], 4),
         "plain_ms": round(total["B", torch.bfloat16][1], 4)},
    ]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
