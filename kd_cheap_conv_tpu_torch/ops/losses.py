"""Segmentation and knowledge-distillation losses, plain PyTorch (the JAX
package's ops/losses.py).

Labels are (N, H, W) integers with `ignore_index` (255) marking void pixels,
the reference's CrossEntropyLoss(ignore_index=255) semantics. Logits are
NCHW (`channel_axis=1`, the port's layout) unless `channel_axis` says
otherwise; every softmax runs in float32, whatever the logits' dtype.
These serve the plain path of `kd_total_loss` (focal loss,
`kl_mask_ignored`); the fused CE+KL, over upsampled and over
full-resolution logits, is ops/losses_fused.py.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IGNORE_INDEX = 255
# exp(-87) is 0 in float32 to within 1e-38: clamping log p_t there before
# the exp changes nothing and keeps an untrained teacher's ~1e6 logit gaps
# from producing -inf * 0
NEG_CLAMP = -87.0


def _valid_and_safe(labels, ignore_index):
    valid = labels != ignore_index
    return valid.float(), torch.where(valid, labels, torch.zeros_like(labels))


def _gather_class(logp, labels, axis):
    return logp.gather(axis, labels.long().unsqueeze(axis)).squeeze(axis)


def cross_entropy(logits, labels, *, ignore_index: int = IGNORE_INDEX,
                  channel_axis: int = 1):
    """Mean CE over non-ignored pixels."""
    mask, safe = _valid_and_safe(labels, ignore_index)
    logp = F.log_softmax(logits.float(), dim=channel_axis)
    nll = -_gather_class(logp, safe, channel_axis)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def focal_loss(logits, labels, *, alpha: float = 1.0, gamma: float = 2.0,
               ignore_index: int = IGNORE_INDEX, channel_axis: int = 1):
    """FL = alpha * (1 - p_t)^gamma * CE, mean over valid pixels."""
    mask, safe = _valid_and_safe(labels, ignore_index)
    logp = F.log_softmax(logits.float(), dim=channel_axis)
    logpt = _gather_class(logp, safe, channel_axis)
    fl = -alpha * (1.0 - logpt.exp()) ** gamma * logpt
    return (fl * mask).sum() / mask.sum().clamp_min(1.0)


def kd_kl_loss(student_logits, teacher_logits, *, temperature: float = 1.0,
               labels=None, ignore_index: int = IGNORE_INDEX,
               channel_axis: int = 1):
    """Pixelwise softened KL, T^2 * KL(softmax(z_t/T) || softmax(z_s/T)),
    mean over all pixels (or over the non-ignored ones if `labels`)."""
    t = float(temperature)
    log_p_s = F.log_softmax(student_logits.float() / t, dim=channel_axis)
    log_p_t = F.log_softmax(teacher_logits.float() / t, dim=channel_axis)
    log_p_t = log_p_t.clamp_min(NEG_CLAMP)
    kl = (log_p_t.exp() * (log_p_t - log_p_s)).sum(channel_axis)
    if labels is not None:
        mask, _ = _valid_and_safe(labels, ignore_index)
        return (t * t) * (kl * mask).sum() / mask.sum().clamp_min(1.0)
    return (t * t) * kl.mean()


def hint_l2_loss(student_feat, teacher_feat):
    """FitNets-style hint: mean squared error between matched feature taps
    (after any channel adapter)."""
    diff = student_feat.float() - teacher_feat.float()
    return (diff * diff).mean()
