"""Val-side joint image+label transforms (the JAX package's
data/transforms.py), numpy only.

Output convention: float32 HWC images normalised with the ImageNet mean and
std, int32 HW labels. The resizing transforms (ExtResize, ExtRandomScale)
need PIL and are not ported yet, so `val_transform` takes no crop size.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class ExtCompose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, img, lbl, rng: np.random.Generator | None = None):
        if rng is None:
            rng = np.random.default_rng()
        for t in self.transforms:
            img, lbl = t(img, lbl, rng)
        return img, lbl


class ExtToNormalizedArray:
    """uint8 HWC -> normalized float32 HWC; label -> int32 HW."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img, lbl, rng=None):
        arr = np.asarray(img, np.float32) / 255.0
        return (arr - self.mean) / self.std, np.asarray(lbl, np.int32)


def val_transform(crop_size: int | None = None) -> ExtCompose:
    """Val pipeline: normalisation only (--crop_val's resize is not ported)."""
    if crop_size is not None:
        raise NotImplementedError("--crop_val needs the PIL resize, which is "
                                  "not ported yet")
    return ExtCompose([ExtToNormalizedArray()])
