"""Host cost and step rates of two checkouts of this repository, in turns on
one card.

    python3 -m kd_cheap_conv_tpu_torch.ab_trees --parent DIR [--out FILE]

DIR is another checkout (a parent commit, unpacked with `git archive`). Each
tree runs in its own process, in the order parent, this tree, this tree,
parent, so that clock and neighbour drift on a shared host hits both alike.
A run builds that tree's kernels and measures, through that tree's own
package and `chip_smoke.py` helpers:

- `host_us`: host microseconds per call of the wide 1x1 forward wrapper
  (`run_bn_pw_wide`, weighted by its 72 calls in a config-#3 step: the
  student's 63 with moments, the teacher's 9 eval entry passes without), of
  the narrow 1x1 forward and backward wrappers (`run_bn_pw`, `run_pw_bwd`,
  each over the 11 links of a config-#2 step), of the decoder's B1 and B2
  wrappers (`run_head_bwd`, `run_sep_bwd`, at config #2's 16 x 129² and
  config #3's 4 x 193²: `head_bwd_host_us`, `x_head_bwd_host_us`,
  `sep_bwd_host_us`, `x_sep_bwd_host_us`), of P1's and of the separable
  conv's (`run_sep_fwd` at the same two geometries; `run_separable`, the
  mean over the three ASPP branches, config #2's 16 x 33² x 320 -> 256 and
  config #3's 4 x 49² x 2048 -> 256: `sep_fwd_host_us`,
  `x_sep_fwd_host_us`, `sep_host_us`, `x_sep_host_us`; and their ms by
  CUDA events over 20 back-to-back calls, the median of ROUNDS, P1's a
  call and the three branches' summed: `sep_fwd_ms`, `x_sep_fwd_ms`,
  `sep_ms`, `x_sep_ms`), of
  the depthwise forward wrappers (`run_bn_dw`,
  `run_bn_dw_s2`: over the 6 links of a config-#2 step, and weighted by the
  72 calls of a config-#3 step, read from the step by `x_step_geometries`)
  and of the eval bottleneck wrapper (`run_bneck_eval`, over the six blocks
  of the ResNet-101 teacher at 16 x 513²), of the eval IR wrappers
  (`fused_mnv2_blocks_eval`, one block a call, the mean over the 14
  stride-1 blocks of the bf16 serving student at batch 4, 513²;
  `fused_ir_block_s2_eval`, over its 3 stride-2 blocks) and of kernels C's
  and D's wrappers (`ce_kl_upsampled_fwd`, `ce_kl_upsampled_bwd`, bf16, at
  config #2's 16 x 21 x 129² -> 513² and config #3's 4 x 19 x 193² ->
  769²: `ce_kl_up_fwd_host_us`, `x_ce_kl_up_fwd_host_us` and the same for
  `bwd`), of the full-resolution loss wrappers (`ce_kl_fwd`, `ce_kl_bwd`,
  at config #1's 16 x 21 x 513², bf16 s, the float16 NHWC teacher:
  `ce_kl_fwd_host_us`, `ce_kl_bwd_host_us`; and their ms a call by CUDA
  events over 20 back-to-back calls, the median of ROUNDS: `ce_kl_fwd_ms`,
  `ce_kl_bwd_ms`), of the teacher stem's wrapper
  (`fused_stem_pool_eval`, bf16, 16 x 513²) and of the depthwise weight
  gradient's (`run_dw_dk`, the mean over the 13 geometries of a config-#2
  step, `dw_geometries`): the CPU wall time of 200
  back-to-back calls on ready inputs without synchronising, over 200; the
  median of three such rounds;
- `train_rate` (config #2, 513², batch 16, bf16), `cached_rate` (config #1:
  the same student, its head separable-converted, reading float16 NHWC
  teacher logits, here seeded random ones) and `x_rate` (config #3, 769²,
  batch 4): 12 untraced steps on a
  device-resident batch after 3 of warm-up, images/s median and quartiles;
  then each step's device busy ms (torch.profiler, `device_split`), its
  split by kernel class and its idle share against the untraced median;
- `validate_rate` (serving: `validate` over 32 synthetic images at 513²,
  batch 4, the bf16 student): 12 untraced passes after 3 of warm-up,
  images/s median and quartiles, then a pass's device busy ms and idle
  share as above.

Prints one JSON line per run and a last line {"runs": [...]}, with the
card's name and power limit in each run. Needs one CUDA card.

    python3 -m kd_cheap_conv_tpu_torch.ab_trees --inject

instead measures how host costs in one wrapper move the host-timed rate:
config #2's step on this tree, in turns, as it is and with the narrow 1x1
backward wrapper (11 calls a step) followed by `torch.cuda.synchronize()`,
by a 100 or 400 microsecond host busy-wait, or by a `torch.zeros` of 256
int32 (an allocation and a memset launch) per call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent

# the wide 1x1 forward's calls in one config-#3 step (Xception-65, 4 x 769²,
# OS16): input NHWC, Co, calls with moments (the student's train chains),
# calls without (the teacher's eval entry blocks)
X_FWD_CALLS = [((4, 385, 385, 64), 128, 1, 1), ((4, 385, 385, 128), 128, 1, 1),
               ((4, 193, 193, 128), 128, 1, 1), ((4, 193, 193, 128), 256, 1, 1),
               ((4, 193, 193, 256), 256, 1, 1), ((4, 97, 97, 256), 256, 1, 1),
               ((4, 97, 97, 256), 728, 1, 1), ((4, 97, 97, 728), 728, 1, 1),
               ((4, 49, 49, 728), 728, 50, 1), ((4, 49, 49, 728), 1024, 1, 0),
               ((4, 49, 49, 1024), 1024, 1, 0),
               ((4, 49, 49, 1024), 1536, 1, 0),
               ((4, 49, 49, 1536), 1536, 1, 0),
               ((4, 49, 49, 1536), 2048, 1, 0)]
CALLS, ROUNDS = 200, 3


def host_us(fn, torch):
    """Median over ROUNDS of the host microseconds per call of CALLS
    back-to-back calls of fn, without synchronising."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        runs.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def rate(step, images_per_step, torch):
    """(median, q1, q3 images/s, median step ms) of 12 untraced steps
    after 3 of warm-up."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    ms = []
    for _ in range(12):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = statistics.quantiles(ms, n=4)
    return {"median_img_per_s": round(images_per_step / med * 1e3, 2),
            "q1_img_per_s": round(images_per_step / q3 * 1e3, 2),
            "q3_img_per_s": round(images_per_step / q1 * 1e3, 2),
            "median_step_ms": round(med, 3)}


def with_busy(row, cs, step, want):
    """row plus the step's device busy ms, its split by kernel class and
    its idle share (device_split)."""
    split, _, _ = cs.device_split(step, want)
    busy = sum(split.values())
    row.update(device_busy_ms=round(busy, 3),
               device_ms={k: round(v, 3) for k, v in split.items() if v},
               device_idle_share=round(1 - busy / row["median_step_ms"], 3))
    return row


def worker(tree: Path) -> dict:
    """One tree's measurements, through its own package and chip_smoke."""
    sys.path[0] = str(tree)
    os.chdir(tree)
    import torch

    import chip_smoke as cs
    from kd_cheap_conv_tpu_torch import native
    from kd_cheap_conv_tpu_torch.ops import stem as tst

    if not torch.cuda.is_available():
        raise SystemExit("ab_trees: torch.cuda.is_available() is false")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    native.build()
    native.library()
    out = {"tree": str(tree), "card": cs.smi("name,power.limit")}
    g = torch.Generator(device="cuda").manual_seed(0)

    tot = calls = 0.0
    for shape, co, n_mom, n_eval in X_FWD_CALLS:
        for moments, n in ((True, n_mom), (False, n_eval)):
            if not n:
                continue
            sig = ("pw", shape, co, False, 1, True, False, moments)
            x, bn, wk, act, eps = cs.x_pass_args(sig, torch.bfloat16, g)
            tot += n * host_us(lambda: tst.run_bn_pw_wide(
                x, bn, wk, act, eps, moments=moments), torch)
            calls += n
            del x, bn, wk
    out["xpw_fwd_host_us"] = round(tot / calls, 2)
    fwd, bwd = cs.pass_geometries()
    for kind, geos in (("bn_pw", fwd), ("pw_bwd", bwd)):
        per = []
        for geo in geos:
            if geo[1] != kind:
                continue
            args = cs.pass_args(geo, torch.bfloat16, g)
            kernel = cs.pass_fns(kind)[0]
            per.append(host_us(lambda: kernel(*args), torch))
            del args
        out[f"{kind}_host_us"] = round(statistics.mean(per), 2)
        out[f"{kind}_host_us_each"] = [round(v, 2) for v in per]
    per = []
    for geo in fwd:
        if geo[1] not in ("bn_dw", "bn_dw_s2"):
            continue
        args = cs.pass_args(geo, torch.bfloat16, g)
        kernel = cs.pass_fns(geo[1])[0]
        per.append(host_us(lambda: kernel(*args), torch))
        del args
    out["bn_dw_host_us"] = round(statistics.mean(per), 2)
    sigs, x_geo = cs.x_step_geometries()
    for tag, geo in (("", cs.HEAD_GEO), ("x_", x_geo["head"])):
        d = cs.head_inputs(torch.bfloat16, g, geo)
        for k in ("head_bwd", "sep_bwd"):
            kernel = cs.head_fns(k, d)[0]
            with torch.no_grad():
                out[f"{tag}{k}_host_us"] = round(host_us(kernel, torch), 2)
        # P1 and the three ASPP branches' separable convs: host us of the
        # wrapper (the trio's mean), ms by CUDA events (the trio's sum)
        trio = [cs.head_fns("sep", d, dil)[0] for dil in d["sep"] if dil != 1]
        for k, fns in (("sep_fwd", [cs.head_fns("sep_fwd", d)[0]]),
                       ("sep", trio)):
            with torch.no_grad():
                out[f"{tag}{k}_host_us"] = round(statistics.mean(
                    host_us(f, torch) for f in fns), 2)
                out[f"{tag}{k}_ms"] = round(statistics.median(
                    sum(cs.cuda_ms(f) for f in fns) for _ in range(ROUNDS)), 4)
        del d, kernel, trio
    counts = {}
    for sg in sigs:
        if sg[0] in ("dw", "dw_s2"):
            counts[sg] = counts.get(sg, 0) + 1
    tot = calls = 0.0
    for sg, n in counts.items():
        args = cs.x_pass_args(sg, torch.bfloat16, g)
        kernel = cs.x_pass_fns("x_bn_dw" if sg[0] == "dw" else "x_bn_dw_s2",
                               sg)[0]
        tot += n * host_us(lambda: kernel(*args), torch)
        calls += n
        del args
    out["x_bn_dw_host_us"] = round(tot / calls, 2)
    from kd_cheap_conv_tpu_torch.models.resnet import resnet101
    from kd_cheap_conv_tpu_torch.ops import rchain as trc

    teacher = resnet101(output_stride=16, dtype=torch.bfloat16).to(
        "cuda", memory_format=torch.channels_last).eval()
    per = []
    with torch.no_grad():
        for blk, shape in ((teacher.layer1[0], (16, 129, 129, 64)),
                           *((b, (16, 129, 129, 256))
                             for b in teacher.layer1[1:]),
                           *((b, (16, 65, 65, 512))
                             for b in teacher.layer2[1:])):
            x = torch.relu(torch.randn(shape, device="cuda", generator=g)).to(
                torch.bfloat16)
            per.append(host_us(lambda: trc.run_bneck_eval(x, blk), torch))
            del x
    out["bneck_host_us"] = round(statistics.mean(per), 2)
    del teacher

    # the eval IR wrappers, one block a call, and kernel D's wrapper
    from kd_cheap_conv_tpu_torch.ops import irchain_eval as ire
    from kd_cheap_conv_tpu_torch.ops import losses_fused as lf

    model = cs.student(torch.bfloat16)
    per = {"A": [], "B": []}
    with torch.no_grad():
        for _, f, shape in cs.block_inputs(model):
            x = torch.randn(shape, device="cuda", generator=g).to(
                torch.bfloat16)
            if ire.ir_block_fusable(f):
                per["A"].append(host_us(
                    lambda: ire.fused_mnv2_blocks_eval(x, (f,)), torch))
            else:
                per["B"].append(host_us(
                    lambda: ire.fused_ir_block_s2_eval(x, f), torch))
            del x
    out["ir_eval_host_us"] = round(statistics.mean(per["A"]), 2)
    out["ir_eval_s2_host_us"] = round(statistics.mean(per["B"]), 2)
    for tag, geo in (("", cs.LOSS_GEO), ("x_", x_geo["loss"])):
        s, t, lbl = cs.loss_inputs(torch.bfloat16, g, geo)
        scales = cs.loss_scales(lbl, geo["args"][2])
        out[f"{tag}ce_kl_up_fwd_host_us"] = round(host_us(
            lambda: lf.ce_kl_upsampled_fwd(s, t, lbl, *geo["args"]), torch), 2)
        out[f"{tag}ce_kl_up_bwd_host_us"] = round(host_us(
            lambda: lf.ce_kl_upsampled_bwd(s, t, lbl, scales, *geo["args"]),
            torch), 2)
        del s, t, lbl
    # the full-resolution loss wrappers at config #1's step
    s, t, lbl = cs.cached_loss_inputs(torch.bfloat16, g)
    scales = cs.loss_scales(lbl)
    full = {"ce_kl_fwd": lambda: lf.ce_kl_fwd(s, t, lbl, 4.0, 255, 3e4),
            "ce_kl_bwd": lambda: lf.ce_kl_bwd(s, t, lbl, scales, 4.0, 255,
                                              3e4)}
    for k, fn in full.items():
        out[f"{k}_host_us"] = round(host_us(fn, torch), 2)
        out[f"{k}_ms"] = round(statistics.median(
            cs.cuda_ms(fn) for _ in range(ROUNDS)), 4)
    del s, t, lbl

    # the teacher stem's wrapper (bf16, 16 x 513²) and the depthwise weight
    # gradient's (the mean over config #2's 13 geometries)
    from kd_cheap_conv_tpu_torch.ops import dwconv as tdw
    from kd_cheap_conv_tpu_torch.ops import tstem as tts

    stem = cs.teacher_stem()
    x = torch.randn(cs.TRAIN_BATCH, cs.CROP, cs.CROP, 3, device="cuda",
                    generator=g).to(torch.bfloat16)
    with torch.no_grad():
        out["tstem_host_us"] = round(host_us(
            lambda: tts.fused_stem_pool_eval(x, stem.conv, stem.bn), torch), 2)
    del stem, x
    per = []
    for _, shape, k, d, dt in cs.dw_geometries():
        x, gg = (torch.randn(shape, device="cuda", generator=g).to(dt)
                 for _ in range(2))
        per.append(host_us(lambda: tdw.run_dw_dk(x, gg, k, d), torch))
        del x, gg
    out["dw_dk_host_us"] = round(statistics.mean(per), 2)

    # serving: validate over 32 images at 513², batch 4, bf16
    from kd_cheap_conv_tpu_torch.data import SyntheticSegmentation
    from kd_cheap_conv_tpu_torch.train.loop import validate

    val = SyntheticSegmentation(cs.N_CLS, size=cs.CROP, length=cs.N_VAL,
                                seed=2)
    batches = []
    for b0 in range(0, cs.N_VAL, cs.BATCH):
        im, lb = zip(*(val[i] for i in range(b0, b0 + cs.BATCH)))
        batches.append((torch.from_numpy(np.stack(im)).float().cuda()
                        .permute(0, 3, 1, 2),
                        torch.from_numpy(np.stack(lb)).long().cuda()))

    def vpass():
        validate(model, batches, num_classes=cs.N_CLS)
    out["validate_rate"] = with_busy(
        rate(vpass, cs.N_VAL, torch), cs, vpass,
        {cs.KERNEL_NAME: 17 * (cs.N_VAL // cs.BATCH)})
    del model, batches

    # config #2, live teacher, then config #1 on the same student setup
    train_ds_images, labels = cs.train_images()
    _, _, kd_step = cs.kd_setup()

    def step():
        kd_step(train_ds_images, labels)
    out["train_rate"] = with_busy(rate(step, cs.TRAIN_BATCH, torch), cs, step,
                                  cs.step_kernel_launches())
    del kd_step
    from kd_cheap_conv_tpu_torch.kd.distill import KDConfig
    from kd_cheap_conv_tpu_torch.kd.replace import (CheapConvSpec,
                                                    replace_cheap_convs)
    from kd_cheap_conv_tpu_torch.models import build_model
    from kd_cheap_conv_tpu_torch.train.optim import make_optimizer
    from kd_cheap_conv_tpu_torch.train.steps import make_kd_train_step

    # config #1's student as main builds it (--replace_scope classifier):
    # the separable-converted head, whose decoder runs P1, P2, B1 and B2
    gen = torch.Generator().manual_seed(1)
    model = build_model("deeplabv3plus_mobilenet", cs.N_CLS, 16,
                        dtype=torch.bfloat16, generator=gen)
    replace_cheap_convs(model, CheapConvSpec(), scope="classifier",
                        generator=gen)
    model = model.to("cuda", memory_format=torch.channels_last)
    opt, sched = make_optimizer(model.named_parameters(), lr=0.01,
                                max_iters=1000)
    c_step = make_kd_train_step(model, None, opt, KDConfig(), sched,
                                cached_teacher=True)
    t_logits = (5 * torch.randn(cs.TRAIN_BATCH, cs.CROP, cs.CROP, cs.N_CLS,
                                device="cuda", generator=g)).half()

    def cstep():
        c_step(train_ds_images, labels, t_logits)
    out["cached_rate"] = with_busy(
        rate(cstep, cs.TRAIN_BATCH, torch), cs, cstep,
        {**{v[0]: v[1] for v in cs.FULL_LOSS.values()},
         cs.HEAD_KERNELS["head_bwd"][0]: 1})
    del model, opt, c_step, t_logits

    x_images, x_labels = cs.x_batch()
    _, _, x_step = cs.x_kd_setup()

    def xstep():
        x_step(x_images, x_labels)
    out["x_rate"] = with_busy(rate(xstep, cs.X_BATCH, torch), cs, xstep,
                              cs.x_step_kernel_launches())
    return out


def inject() -> dict:
    """Config #2's step rate on this tree with host costs added to every
    call of the narrow 1x1 backward wrapper, in turns (each variant twice,
    mirrored: A B C ... C B A)."""
    sys.path[0] = str(HERE)
    os.chdir(HERE)
    import torch

    import chip_smoke as cs
    from kd_cheap_conv_tpu_torch.ops import stem as tst

    if not torch.cuda.is_available():
        raise SystemExit("ab_trees: torch.cuda.is_available() is false")
    launch = tst._launch_pw_bwd

    def spin(us):
        end = time.perf_counter() + us * 1e-6
        while time.perf_counter() < end:
            pass

    variants = {
        "none": launch,
        "sync": lambda *a: (launch(*a), torch.cuda.synchronize())[0],
        "delay_100us": lambda *a: (spin(100), launch(*a))[1],
        "delay_400us": lambda *a: (spin(400), launch(*a))[1],
        "zeros_256": lambda *a: (torch.zeros(256, dtype=torch.int32,
                                             device="cuda"), launch(*a))[1],
    }
    images, labels = cs.train_images()
    _, _, kd_step = cs.kd_setup()
    out = {"card": cs.smi("name,power.limit"), "variants": {}}
    order = list(variants) + list(reversed(variants))
    try:
        for name in order:
            tst._launch_pw_bwd = variants[name]
            r = rate(lambda: kd_step(images, labels), cs.TRAIN_BATCH, torch)
            out["variants"].setdefault(name, []).append(r)
    finally:
        tst._launch_pw_bwd = launch
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="the other checkout")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help="also write the runs here")
    ap.add_argument("--inject", action="store_true",
                    help="the rate's response to host costs in a wrapper")
    a = ap.parse_args(argv)
    if a.inject:
        print(json.dumps(inject()))
        return 0
    if a.worker is not None:
        print(json.dumps(worker(a.worker.resolve())), flush=True)
        return 0
    if a.parent is None:
        ap.error("--parent is required")
    parent = a.parent.resolve()
    if not (parent / "chip_smoke.py").exists():
        ap.error(f"{parent} is no checkout of this repository")
    runs = []
    for name, tree in (("parent", parent), ("change", HERE),
                       ("change", HERE), ("parent", parent)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--worker", str(tree)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            raise SystemExit(f"ab_trees: the {name} run failed "
                             f"({proc.returncode})")
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        run = {"run": name, **json.loads(lines[-1])}
        print(json.dumps(run), flush=True)
        runs.append(run)
    print(json.dumps({"runs": runs}))
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps({"runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
