"""Bilinear resize with the JAX package's semantics (ops/resize.py).

Half-pixel centres (align_corners=False) without antialiasing, for both
down- and upsampling: `jax.image.resize(method="bilinear",
antialias=False)` and torch's `F.interpolate(mode="bilinear",
align_corners=False)` sample the same points with the same weights. The
memory format of the input is kept.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Resize NCHW `x` to spatial `size` = (H, W)."""
    oh, ow = int(size[0]), int(size[1])
    if (oh, ow) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=(oh, ow), mode="bilinear",
                         align_corners=False, antialias=False)
