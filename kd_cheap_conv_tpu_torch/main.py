"""Serving entry point of the PyTorch port: the `--test_only` path of the
JAX package's main.py, with the same flags plus --device.

    python -m kd_cheap_conv_tpu_torch.main --test_only --dataset synthetic \
        --model deeplabv3plus_mobilenet --kd --replace_scope classifier \
        --crop_size 513 --val_batch_size 4 --bf16 [--tta]

builds the model from --random_seed, applies the cheap-conv surgery
(--kd, --separable_conv), runs `validate` (or multi-scale + flip TTA) over
the 32 synthetic val images and prints the StreamSegMetrics table. Training
and --ckpt are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import random

import numpy as np
import torch


def get_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="DeepLab KD cheap-conv student, eval and TTA (PyTorch)")
    p.add_argument("--dataset", type=str, default="synthetic",
                   choices=["synthetic"])
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--model", type=str, default="deeplabv3plus_mobilenet")
    p.add_argument("--separable_conv", action="store_true",
                   help="apply separable conv to decoder and aspp")
    p.add_argument("--output_stride", type=int, default=16, choices=[8, 16])
    p.add_argument("--test_only", action="store_true")
    p.add_argument("--val_batch_size", type=int, default=4)
    p.add_argument("--crop_size", type=int, default=513)
    p.add_argument("--random_seed", type=int, default=1)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (params and BN stats stay f32)")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--kd", action="store_true",
                   help="evaluate the cheap-conv student (mirror the "
                        "train-time surgery)")
    p.add_argument("--cheap_conv", type=str, default="separable",
                   choices=["separable", "grouped"])
    p.add_argument("--cheap_groups", type=int, default=4)
    p.add_argument("--cheap_init", type=str, default="factorize",
                   choices=["factorize", "random"])
    p.add_argument("--replace_scope", type=str, default=None,
                   help="comma list of dotted path prefixes to replace")
    p.add_argument("--tta", action="store_true",
                   help="multi-scale+flip TTA during --test_only")
    p.add_argument("--tta_scales", type=str,
                   default="0.5,0.75,1.0,1.25,1.5,1.75")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; a CUDA device that is not there "
                        "raises (no move to the CPU)")
    return p


def main(argv=None) -> int:
    opts = get_argparser().parse_args(argv)
    if not opts.test_only:
        raise NotImplementedError("only --test_only is ported; training "
                                  "comes with the config-#2 train step "
                                  "(ROADMAP.md)")
    device = torch.device(opts.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {opts.device}: no CUDA device here")

    from .data import SyntheticSegmentation, make_loader, prefetch_to_device
    from .inference import make_tta_predict_fn
    from .kd.replace import (CheapConvSpec, convert_to_separable_conv,
                             replace_cheap_convs)
    from .models import build_model
    from .models.layers import set_bn_momentum
    from .train.loop import validate
    from .utils import StreamSegMetrics

    random.seed(opts.random_seed)
    np.random.seed(opts.random_seed)
    generator = torch.Generator().manual_seed(opts.random_seed)

    num_classes = opts.num_classes or 21
    val_dst = SyntheticSegmentation(num_classes, size=opts.crop_size,
                                    length=32, seed=opts.random_seed + 1)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"Device: {device} ({name})")
    print(f"Dataset: {opts.dataset}, Val set: {len(val_dst)}")

    dtype = torch.bfloat16 if opts.bf16 else None
    model = build_model(opts.model, num_classes, opts.output_stride,
                        dtype=dtype, generator=generator)
    if opts.separable_conv:
        convert_to_separable_conv(model.classifier, generator=generator)
    set_bn_momentum(model.backbone, 0.01)
    if opts.kd:
        spec = CheapConvSpec(kind=opts.cheap_conv, groups=opts.cheap_groups,
                             init=opts.cheap_init)
        scope = (tuple(opts.replace_scope.split(","))
                 if opts.replace_scope else None)
        replaced = replace_cheap_convs(model, spec, scope=scope,
                                       generator=generator)
        print(f"Cheap-conv student: replaced {len(replaced)} convs "
              f"({opts.cheap_conv}, init={opts.cheap_init})")
    model = model.to(device=device, memory_format=torch.channels_last)
    model.eval()

    val_loader = prefetch_to_device(
        make_loader(val_dst, batch_size=opts.val_batch_size, shuffle=False,
                    drop_last=False, num_epochs=1,
                    num_workers=opts.num_workers),
        device)
    if opts.tta:
        scales = tuple(float(s) for s in opts.tta_scales.split(","))
        tta_fn = make_tta_predict_fn(model, scales=scales, flip=True)
        metrics = StreamSegMetrics(num_classes)
        for images, labels in val_loader:
            preds, _ = tta_fn(images)
            metrics.update(labels.cpu().numpy(), preds.cpu().numpy())
        results = metrics.get_results()
    else:
        results = validate(model, val_loader, num_classes=num_classes)
    print(StreamSegMetrics.to_str(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
