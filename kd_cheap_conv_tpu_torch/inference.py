"""Plain prediction and multi-scale + flip TTA (the JAX package's
inference.py, config #5).

For each scale s: resize the batch to (round(h*s), round(w*s)), stack it
with its mirror image on the batch axis (one forward of 2N images per
scale), resize the logits back to (h, w), softmax in f32, un-mirror and
accumulate; the prediction is the argmax of the mean probabilities. The
scale rounding is Python's round (half to even), as in the JAX package.
Images are NCHW (channels_last); the model must be in eval mode.
"""

from __future__ import annotations

import torch

from .ops.resize import resize_bilinear


def make_predict_fn(model):
    """Returns (images NCHW) -> preds (N, H, W) int64."""

    @torch.no_grad()
    def predict(images):
        return model(images).argmax(dim=1)

    return predict


def make_tta_predict_fn(model, *,
                        scales: tuple[float, ...] = (0.5, 0.75, 1.0, 1.25,
                                                     1.5, 1.75),
                        flip: bool = True):
    """Returns (images NCHW) -> (preds (N, H, W), mean probs (N, C, H, W))."""
    scales = tuple(float(s) for s in scales)

    @torch.no_grad()
    def tta(images):
        n, _, h, w = images.shape
        prob_sum = None
        for s in scales:
            sh, sw = max(1, int(round(h * s))), max(1, int(round(w * s)))
            x = resize_bilinear(images, (sh, sw))
            if flip:
                x = torch.cat([x, x.flip(3)], dim=0)
            logits = resize_bilinear(model(x), (h, w))
            probs = torch.softmax(logits.float(), dim=1)
            if flip:
                probs = probs[:n] + probs[n:].flip(3)
            prob_sum = probs if prob_sum is None else prob_sum + probs
        mean_probs = prob_sum / (len(scales) * (2 if flip else 1))
        return mean_probs.argmax(dim=1), mean_probs

    return tta
