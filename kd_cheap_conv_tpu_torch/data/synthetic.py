"""Synthetic segmentation data — the offline stand-in for VOC/Cityscapes,
sample for sample the JAX package's data/synthetic.py.

Deterministic per index: sample i is reproducible regardless of worker
order.
"""

from __future__ import annotations

import numpy as np


class SyntheticSegmentation:
    """Blobby class regions + textured images; plausible label statistics
    (large connected regions, some void)."""

    ignore_index = 255

    def __init__(self, num_classes: int = 21, size=(512, 512),
                 length: int = 1024, transform=None, seed: int = 0,
                 void_fraction: float = 0.05):
        self.num_classes = num_classes
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.length = length
        self.transform = transform
        self.seed = seed
        self.void_fraction = void_fraction

    def __len__(self):
        return self.length

    def __getitem__(self, idx, rng: np.random.Generator | None = None):
        gen = np.random.default_rng((self.seed, idx))
        h, w = self.size
        # low-res class field upsampled -> large connected regions
        lowres = gen.integers(0, self.num_classes, (h // 32 + 1, w // 32 + 1))
        lbl = np.kron(lowres, np.ones((32, 32), dtype=np.int64))[:h, :w]
        if self.void_fraction > 0:
            void = gen.random((h // 32 + 1, w // 32 + 1)) < self.void_fraction
            voidmap = np.kron(void, np.ones((32, 32), dtype=bool))[:h, :w]
            lbl = np.where(voidmap, self.ignore_index, lbl)
        # the palette is the task's semantics (colour -> class), fixed
        # independently of `seed` so train and val splits share it
        palette = np.random.default_rng(0x5EED).integers(
            0, 255, (max(self.num_classes, 256), 3))
        img = palette[np.where(lbl == self.ignore_index, 0, lbl)]
        img = img + gen.normal(0, 20, (h, w, 3))
        img = np.clip(img, 0, 255).astype(np.uint8)
        lbl = lbl.astype(np.uint8)
        if self.transform is not None:
            img, lbl = self.transform(img, lbl, rng)
        return img, lbl
