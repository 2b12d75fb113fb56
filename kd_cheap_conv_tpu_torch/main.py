"""Entry point of the PyTorch port: the JAX package's main.py flags for the
paths ported so far, plus --device.

Training (config #2, a KD step with a live ResNet-101 teacher):

    python -m kd_cheap_conv_tpu_torch.main --kd --dataset synthetic \\
        --model deeplabv3plus_mobilenet --teacher_model deeplabv3plus_resnet101 \\
        --replace_scope classifier --crop_size 513 --batch_size 16 --bf16 \\
        --total_itrs N --val_interval N

builds the student and the teacher from --random_seed, applies the
cheap-conv surgery after the teacher is built, and trains on the 256
synthetic train images with SGD + PolyLR, validating on the 32 synthetic
val images and writing latest/best checkpoints under --ckpt_dir. Without
--kd it trains the model alone with the supervised step.

Serving (`--test_only`): the same surgery (--kd, --separable_conv), then
`validate` (or multi-scale + flip TTA) over the 32 val images and the
StreamSegMetrics table.

Cached-teacher training (config #1): with --kd --cached_logits FILE the
teacher's logits over the train set are precomputed into FILE if it is
missing (batches of --cache_batch_size, default --val_batch_size), the train
set is wrapped to yield them, and the student trains without a teacher in
the loop, its full-resolution logits against the cached ones.
--cached_det_transform asks for deterministic train transforms; the
synthetic train set has no random transform, so it changes nothing there.

Data-parallel training (the JAX flags): --multihost with
--coordinator_address host:port (rank 0's), --num_processes W and
--process_id r, one process per rank, or torchrun's RANK / WORLD_SIZE /
MASTER_ADDR / MASTER_PORT / LOCAL_RANK in their place. Each rank takes
cuda:{local rank % cards} (unless --device cpu) and its rows of every
global batch (--batch_size stays the global batch, as in the JAX package);
the chains, the decoder head, the module-path BNs and the fused losses
reduce their moments and sums over the ranks, and the step sums the
gradients. NCCL where each rank has a card of its own, gloo on the CPU or
where ranks share a card. Rank 0 writes the checkpoints and prints; every
rank prints its loss lines, which are the global batch's.

    python -m kd_cheap_conv_tpu_torch.main --kd ... --multihost \
        --coordinator_address 127.0.0.1:29500 --num_processes 2 \
        --process_id 0   # and 1, in a second process

Flags of paths not ported yet (--ckpt, --teacher_ckpt, --progressive, VOC
and Cityscapes; an Xception model trained under more than one rank) raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch


def get_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="DeepLab KD by cheap-conv replacement (PyTorch)")
    p.add_argument("--dataset", type=str, default="synthetic",
                   choices=["voc", "cityscapes", "synthetic"])
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--model", type=str, default="deeplabv3plus_mobilenet")
    p.add_argument("--separable_conv", action="store_true",
                   help="apply separable conv to decoder and aspp")
    p.add_argument("--output_stride", type=int, default=16, choices=[8, 16])
    p.add_argument("--test_only", action="store_true")
    p.add_argument("--total_itrs", type=int, default=30_000)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--lr_policy", type=str, default="poly",
                   choices=["poly", "step"])
    p.add_argument("--step_size", type=int, default=10_000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--val_batch_size", type=int, default=4)
    p.add_argument("--crop_size", type=int, default=513)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--continue_training", action="store_true")
    p.add_argument("--loss_type", type=str, default="cross_entropy",
                   choices=["cross_entropy", "focal_loss"])
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--random_seed", type=int, default=1)
    p.add_argument("--print_interval", type=int, default=10)
    p.add_argument("--val_interval", type=int, default=100)
    p.add_argument("--ckpt_dir", type=str, default="checkpoints")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (params and BN stats stay f32)")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--kd", action="store_true",
                   help="KD training; with --test_only, evaluate the "
                        "cheap-conv student (mirror the train-time surgery)")
    p.add_argument("--teacher_model", type=str,
                   default="deeplabv3plus_resnet101")
    p.add_argument("--teacher_ckpt", type=str, default=None)
    p.add_argument("--kd_temperature", type=float, default=4.0)
    p.add_argument("--kd_alpha", type=float, default=0.5)
    p.add_argument("--kd_beta", type=float, default=0.5)
    p.add_argument("--kd_gamma", type=float, default=0.0)
    p.add_argument("--hint_taps", type=str, default="",
                   help="comma list from {low_level,out,head}")
    p.add_argument("--cheap_conv", type=str, default="separable",
                   choices=["separable", "grouped"])
    p.add_argument("--cheap_groups", type=int, default=4)
    p.add_argument("--cheap_init", type=str, default="factorize",
                   choices=["factorize", "random"])
    p.add_argument("--replace_scope", type=str, default=None,
                   help="comma list of dotted path prefixes to replace")
    p.add_argument("--progressive", action="store_true")
    p.add_argument("--cached_logits", type=str, default=None,
                   help="npz file of cached teacher logits (config #1 mode)")
    p.add_argument("--cache_batch_size", type=int, default=None,
                   help="batch size of the one-off teacher-logit precompute "
                        "sweep (defaults to --val_batch_size)")
    p.add_argument("--cached_det_transform", action="store_true",
                   help="with --cached_logits: deterministic train "
                        "transforms (the synthetic train set has no random "
                        "transform)")
    p.add_argument("--tta", action="store_true",
                   help="multi-scale+flip TTA during --test_only")
    p.add_argument("--tta_scales", type=str,
                   default="0.5,0.75,1.0,1.25,1.5,1.75")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; a CUDA device that is not there "
                        "raises (no move to the CPU)")
    p.add_argument("--multihost", action="store_true",
                   help="join a torch.distributed group of "
                        "--num_processes ranks (one process per rank)")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 (default: torchrun's "
                        "MASTER_ADDR / MASTER_PORT)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


# flag -> the ROADMAP.md item that ports it
_QUEUED = {
    "ckpt": "Queue 1 item 9 (resume and --ckpt)",
    "continue_training": "Queue 1 item 9 (resume and --ckpt)",
    "teacher_ckpt": "Queue 1 item 9 (teacher checkpoint import)",
    "progressive": "Queue 1 item 6 (progressive mode)",
}


def _refuse_queued(opts) -> None:
    for flag, item in _QUEUED.items():
        if getattr(opts, flag):
            raise NotImplementedError(f"--{flag} is not ported yet "
                                      f"(ROADMAP.md, {item})")
    if opts.dataset != "synthetic":
        raise NotImplementedError(f"--dataset {opts.dataset} is not ported "
                                  f"yet (ROADMAP.md, Queue 1 item 5: data)")


def _cheap_conv_surgery(model, opts, generator, log=print) -> None:
    from .kd.replace import CheapConvSpec, replace_cheap_convs

    spec = CheapConvSpec(kind=opts.cheap_conv, groups=opts.cheap_groups,
                         init=opts.cheap_init)
    scope = (tuple(opts.replace_scope.split(","))
             if opts.replace_scope else None)
    replaced = replace_cheap_convs(model, spec, scope=scope,
                                   generator=generator)
    log(f"Cheap-conv student: replaced {len(replaced)} convs "
        f"({opts.cheap_conv}, init={opts.cheap_init})")


def _val_loader(val_dst, opts, device, group=None):
    from .data import make_loader, prefetch_to_device

    return prefetch_to_device(
        make_loader(val_dst, batch_size=opts.val_batch_size, shuffle=False,
                    drop_last=False, num_epochs=1,
                    num_workers=opts.num_workers),
        device, group=group)


def _check_ranks(opts, world: int) -> None:
    """What cannot run under `world` > 1 ranks, refused before any rank
    joins the group: an Xception model in training (its train chains'
    sharded wrappers are not ported), and a global batch that does not
    divide over the ranks."""
    if world <= 1:
        return
    if not opts.test_only and "xception" in opts.model:
        raise NotImplementedError(
            f"--model {opts.model} under {world} ranks: the Xception train "
            f"chains' sharded wrappers are not ported yet (ROADMAP.md, "
            f"Queue 2)")
    for flag in ("batch_size", "val_batch_size"):
        if getattr(opts, flag) % world:
            raise ValueError(f"--{flag} {getattr(opts, flag)} does not "
                             f"divide over {world} ranks")


def _join_group(opts, device):
    """--multihost: check what the ranks cannot run, pick this rank's card
    and join the group. Returns (group, device)."""
    from .parallel import init_distributed

    world = opts.num_processes or int(os.environ["WORLD_SIZE"])
    _check_ranks(opts, world)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", opts.process_id
                                   if opts.process_id is not None
                                   else os.environ["RANK"]))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    group = init_distributed(opts.coordinator_address, world,
                             opts.process_id, device=device)
    return group, device


def main(argv=None) -> int:
    opts = get_argparser().parse_args(argv)
    device = torch.device(opts.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {opts.device}: no CUDA device here")
    _refuse_queued(opts)
    if not opts.multihost:
        return _run(opts, device, None)
    from .parallel import shutdown

    group, device = _join_group(opts, device)
    try:
        return _run(opts, device, group)
    finally:
        shutdown()


def _run(opts, device, group) -> int:
    """Serve or train on `device`, as rank `rank(group)` of the group (None:
    one process)."""
    from .data import SyntheticSegmentation
    from .kd.replace import convert_to_separable_conv
    from .models import build_model
    from .models.layers import set_bn_momentum
    from .parallel import rank

    log = print if rank(group) == 0 else _quiet
    random.seed(opts.random_seed)
    np.random.seed(opts.random_seed)
    # the global stream (ASPP's dropout) from the seed, one per rank; every
    # weight is drawn from `generator`, the same on every rank
    torch.manual_seed(opts.random_seed + rank(group))
    generator = torch.Generator().manual_seed(opts.random_seed)

    num_classes = opts.num_classes or 21
    val_dst = SyntheticSegmentation(num_classes, size=opts.crop_size,
                                    length=32, seed=opts.random_seed + 1)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    log(f"Device: {device} ({name})")

    dtype = torch.bfloat16 if opts.bf16 else None
    model = build_model(opts.model, num_classes, opts.output_stride,
                        dtype=dtype, generator=generator)
    if opts.separable_conv:
        convert_to_separable_conv(model.classifier, generator=generator)
    set_bn_momentum(model.backbone, 0.01)
    if opts.test_only:
        log(f"Dataset: {opts.dataset}, Val set: {len(val_dst)}")
        if opts.kd:
            _cheap_conv_surgery(model, opts, generator, log)
        return _serve(model, val_dst, num_classes, opts, device, group, log)

    train_dst = SyntheticSegmentation(num_classes, size=opts.crop_size,
                                      length=256, transform=None,
                                      seed=opts.random_seed)
    log(f"Dataset: {opts.dataset}, Train set: {len(train_dst)}, "
        f"Val set: {len(val_dst)}")
    return _train(model, train_dst, val_dst, num_classes, opts, device,
                  dtype, generator, group, log)


def _quiet(*args, **kwargs) -> None:
    """The print of ranks other than 0."""


def _serve(model, val_dst, num_classes, opts, device, group, log) -> int:
    from .inference import make_tta_predict_fn
    from .parallel import all_reduce_sum
    from .train.loop import validate
    from .utils import StreamSegMetrics

    model = model.to(device=device, memory_format=torch.channels_last)
    model.eval()
    val_loader = _val_loader(val_dst, opts, device, group)
    if opts.tta:
        scales = tuple(float(s) for s in opts.tta_scales.split(","))
        tta_fn = make_tta_predict_fn(model, scales=scales, flip=True)
        metrics = StreamSegMetrics(num_classes)
        for images, labels in val_loader:
            preds, _ = tta_fn(images)
            metrics.update(labels.cpu().numpy(), preds.cpu().numpy())
        cm = torch.from_numpy(metrics.confusion_matrix).to(device)
        results = StreamSegMetrics.from_confusion_matrix(
            all_reduce_sum(cm, group).cpu().numpy())
    else:
        results = validate(model, val_loader, num_classes=num_classes)
    log(StreamSegMetrics.to_str(results))
    return 0


def _train(model, train_dst, val_dst, num_classes, opts, device, dtype,
           generator, group, log) -> int:
    from .data import make_loader, prefetch_to_device
    from .kd.distill import KDConfig, make_hint_adapters
    from .models import build_model
    from .parallel import replicate
    from .train.loop import LoopConfig, train_loop, validate
    from .train.optim import make_optimizer
    from .train.steps import (TrainState, make_eval_step, make_kd_train_step,
                              make_train_step)

    hint_taps = tuple(t for t in opts.hint_taps.split(",") if t)
    kd_cfg = KDConfig(temperature=opts.kd_temperature, alpha=opts.kd_alpha,
                      beta=opts.kd_beta, gamma=opts.kd_gamma,
                      hint_taps=hint_taps, loss_type=opts.loss_type)
    teacher = adapters = None
    if opts.kd:
        teacher = build_model(
            opts.teacher_model, num_classes, opts.output_stride, dtype=dtype,
            generator=torch.Generator().manual_seed(opts.random_seed + 1))
        # the student is the cheap-conv replacement of the chosen scope,
        # made after the teacher is built (the JAX package's order)
        _cheap_conv_surgery(model, opts, generator, log)
        if hint_taps and not opts.cached_logits:
            adapters = make_hint_adapters(model, teacher, hint_taps,
                                          dtype=dtype, generator=generator)
        teacher = teacher.to(device=device,
                             memory_format=torch.channels_last).eval()
        if opts.cached_logits:
            # config #1: the student trains against precomputed logits; the
            # teacher leaves the training loop
            from .kd.cached import CachedLogitsDataset, ensure_teacher_logits

            ensure_teacher_logits(
                teacher, train_dst, opts.cached_logits,
                batch_size=opts.cache_batch_size or opts.val_batch_size,
                seed=opts.random_seed, group=group, log_fn=log)
            train_dst = CachedLogitsDataset(train_dst, opts.cached_logits)
            teacher = None
    model = replicate(
        model.to(device=device, memory_format=torch.channels_last), group)
    named = list(model.named_parameters())
    if adapters is not None:
        adapters = adapters.to(device=device,
                               memory_format=torch.channels_last)
        named += [(f"adapters.{n}", p) for n, p in adapters.named_parameters()]
    optimizer, scheduler = make_optimizer(
        named, lr=opts.lr, max_iters=opts.total_itrs,
        weight_decay=opts.weight_decay, lr_policy=opts.lr_policy,
        step_size=opts.step_size)
    if opts.kd:
        step_fn = make_kd_train_step(model, teacher, optimizer, kd_cfg,
                                     scheduler, adapters=adapters,
                                     cached_teacher=teacher is None)
    else:
        step_fn = make_train_step(model, optimizer, scheduler,
                                  loss_type=opts.loss_type)
    train_iter = prefetch_to_device(
        make_loader(train_dst, batch_size=opts.batch_size, shuffle=True,
                    seed=opts.random_seed, num_workers=opts.num_workers),
        device, group=group)
    eval_step = make_eval_step(model, num_classes=num_classes)

    def validate_fn(state):
        return validate(state.model, _val_loader(val_dst, opts, device,
                                                 group),
                        num_classes=num_classes, eval_step=eval_step)

    loop_cfg = LoopConfig(total_itrs=opts.total_itrs,
                          print_interval=opts.print_interval,
                          val_interval=opts.val_interval,
                          ckpt_dir=opts.ckpt_dir, model_name=opts.model,
                          dataset_name=opts.dataset,
                          output_stride=opts.output_stride)
    state = TrainState(model, optimizer, scheduler, adapters)
    try:
        _, best = train_loop(state=state, step_fn=step_fn,
                             train_iter=train_iter, cfg=loop_cfg,
                             validate_fn=validate_fn)
    finally:
        train_iter.close()
    log(f"Best Mean IoU: {best:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
