"""Eval step (the JAX package's train/steps.py `make_eval_step`).

The training steps are not ported yet (ROADMAP.md, config-#2 train step).
"""

from __future__ import annotations

import torch


def make_eval_step(model, *, num_classes: int):
    """(images NCHW, labels NHW) -> (confusion counts (C, C) int64 on the
    device, preds NHW). Rows are true classes, columns predictions; labels
    outside 0 <= label < C (the 255 void) are not counted, as in the
    reference's _fast_hist. The counts go through `index_add_` into a
    fixed-size vector: `torch.bincount` on a CUDA tensor reads the input's
    maximum back to the host, a sync per batch that stops the host from
    queueing the next batch while the device works."""
    c = num_classes

    @torch.no_grad()
    def eval_step(images, labels):
        preds = model(images, class_major=True).argmax(dim=1)
        labels = labels.long()
        valid = (labels >= 0) & (labels < c)
        idx = torch.where(valid, labels * c + preds, c * c).reshape(-1)
        counts = torch.zeros(c * c + 1, dtype=torch.long, device=idx.device)
        counts.index_add_(0, idx, torch.ones_like(idx))
        return counts[:-1].reshape(c, c), preds

    return eval_step
