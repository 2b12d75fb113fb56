"""validate (the JAX package's train/loop.py). The training loop is not
ported yet (ROADMAP.md, config-#2 train step)."""

from __future__ import annotations

from typing import Iterator

import torch

from ..utils.metrics import StreamSegMetrics
from .steps import make_eval_step


def validate(model, loader: Iterator, *, num_classes: int,
             eval_step=None) -> dict:
    """Run eval over a loader of device batches (images NCHW, labels NHW);
    returns the StreamSegMetrics results dict. The confusion matrix is
    summed in int64 on the device and read back once at the end."""
    model.eval()
    if eval_step is None:
        eval_step = make_eval_step(model, num_classes=num_classes)
    cm = None
    for images, labels in loader:
        counts, _ = eval_step(images, labels)
        cm = counts if cm is None else cm + counts
    if cm is None:
        cm = torch.zeros((num_classes, num_classes), dtype=torch.long)
    return StreamSegMetrics.from_confusion_matrix(cm.cpu().numpy())
