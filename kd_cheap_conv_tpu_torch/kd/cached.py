"""Cached-teacher-logits mode (config #1; the JAX package's kd/cached.py):
the teacher's forward runs once over the train set and its logits are
stored, so the student trains without a teacher in the loop.

1. `precompute_teacher_logits(teacher, dataset, path)` runs the eval-mode
   teacher under no_grad on its device over the (transformed) dataset and
   writes the logits;
2. `CachedLogitsDataset(dataset, path)` wraps the dataset so that
   `__getitem__` yields (image, label, teacher logits), for
   `make_kd_train_step(..., cached_teacher=True)`.

The file is the contract between the two packages: `np.savez_compressed`
with `logits` (N, H, W, C) float16, `seed` and `epoch`; sample i is drawn
with `np.random.default_rng((seed, epoch, i))`. A cache written by either
package reads in the other. The logits come back as the float16 the file
holds (the JAX package widens them to float32 on the host): widening is
exact, the loss kernel reads float16, and a batch moves half the bytes to
the device.

As in the reference, augmentations must be deterministic per index: every
epoch replays the cache's (seed, epoch) stream, so the pixels match the
logits.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..parallel.mesh import barrier, rank


def precompute_teacher_logits(teacher, dataset, path: str, *,
                              batch_size: int = 8, seed: int = 0,
                              epoch: int = 0) -> str:
    """Run the teacher in eval mode over `dataset` (its transform included)
    on the teacher's device and save the logits; returns `path`."""
    device = next(teacher.parameters()).device
    teacher.eval()
    logits_all = []
    n = len(dataset)
    with torch.no_grad():
        for start in range(0, n, batch_size):
            samples = [dataset.__getitem__(
                i, np.random.default_rng((seed, epoch, i)))
                for i in range(start, min(start + batch_size, n))]
            images = torch.from_numpy(
                np.stack([s[0] for s in samples]).astype(np.float32))
            out = teacher(images.to(device).permute(0, 3, 1, 2))
            logits_all.append(out.permute(0, 2, 3, 1).to(torch.float16)
                              .cpu().numpy())
    np.savez_compressed(path, logits=np.concatenate(logits_all), seed=seed,
                        epoch=epoch)
    return path


def ensure_teacher_logits(teacher, dataset, path: str, *, batch_size: int,
                          seed: int = 0, group=None, log_fn=print) -> str:
    """Build the cache at `path` if it is missing; returns `path`. Under a
    group of more than one rank, rank 0 alone looks for the file and builds
    it while the others wait at a barrier (the group's timeout bounds the
    wait); then every rank reads the file and its loader takes its rows
    (`prefetch_to_device(group=...)`)."""
    if rank(group) == 0 and not os.path.exists(path):
        log_fn(f"Precomputing teacher logits -> {path}")
        precompute_teacher_logits(teacher, dataset, path,
                                  batch_size=batch_size, seed=seed)
    barrier(group)
    return path


class CachedLogitsDataset:
    """Wraps a dataset to yield (image, label, teacher logits (H, W, C)
    float16)."""

    def __init__(self, dataset, path: str):
        self.dataset = dataset
        data = np.load(path)
        self.logits = data["logits"]
        self.seed = int(data["seed"])
        self.epoch = int(data["epoch"])
        if len(self.logits) != len(dataset):
            raise ValueError(f"cache has {len(self.logits)} entries, dataset "
                             f"has {len(dataset)}")

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx, rng=None):
        # the cache's per-sample stream, whatever the loader passes, so the
        # pixels match the logits
        rng = np.random.default_rng((self.seed, self.epoch, int(idx)))
        img, lbl = self.dataset.__getitem__(idx, rng)
        return img, lbl, self.logits[idx]
