"""KD objective: task CE + pixelwise softened KL + feature hints (the JAX
package's kd/distill.py), L = alpha * CE + beta * T^2 * KL + gamma * hint.

- `kd_total_loss_small`: from head-resolution class-major logits, with the
  16x bilinear upsample fused into the loss kernels
  (ops.losses_fused), so the full-resolution logits are never formed;
- `kd_total_loss`: on full-resolution logits (the cached-teacher step).
  Class-major logits with a fused-applicable config go through the fused
  full-resolution CE + KL (ops.losses_fused `fused_ce_kl_loss`, as the JAX
  package's kd_total_loss takes its Pallas kernel); focal loss,
  `kl_mask_ignored` or another channel axis take the plain losses. The
  plain path clips the teacher after the upsample, as the JAX plain path
  does; the upsample-fused path clips before it, as the JAX kernel does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ..models.layers import Conv2d
from ..ops.losses import cross_entropy, focal_loss, hint_l2_loss, kd_kl_loss
from ..ops.losses_fused import (fused_ce_kl_loss_sharded,
                                 fused_ce_kl_loss_upsampled_sharded)
from ..ops.resize import resize_bilinear
from ..parallel.mesh import sharded_group

# what ports the losses below under a group of more than one rank
RANKS_ITEM = ("ROADMAP.md, Queue 1 item 10: the unfused losses under "
              "ranks")


def refuse_under_ranks(what: str) -> None:
    """Raise NotImplementedError when a group of more than one rank is
    active: `what` takes per-rank means, which under ranks would silently
    train another model (the fused losses and chains take global ones)."""
    if sharded_group() is not None:
        raise NotImplementedError(f"{what} under more than one rank: its "
                                  f"means would be per rank ({RANKS_ITEM})")


@dataclasses.dataclass(frozen=True)
class KDConfig:
    temperature: float = 4.0
    alpha: float = 0.5          # hard-label task loss weight
    beta: float = 0.5           # softened-KL weight
    gamma: float = 0.0          # feature-hint weight
    hint_taps: tuple[str, ...] = ()   # subset of {'low_level','out','head'}
    loss_type: str = "cross_entropy"  # 'cross_entropy' | 'focal_loss'
    kl_mask_ignored: bool = False     # mask KL at ignore-index pixels
    # Teacher logits are clipped to +-this before the KL: a trained
    # teacher's logits are O(10), so this is a no-op; an untrained eval-mode
    # teacher can emit |logits| ~ 1e6.
    teacher_logit_clip: float = 3.0e4


class HintAdapters(nn.Module):
    """Per-tap 1x1 conv adapters mapping student feature channels to the
    teacher's (FitNets hints need channel alignment). A tap whose widths
    already agree has no adapter."""

    def __init__(self, tap_channels: dict[str, tuple[int, int]], *,
                 dtype=None, generator=None):
        super().__init__()
        self.taps = tuple(sorted(tap_channels))
        for tap in self.taps:
            s_ch, t_ch = tap_channels[tap]
            adapter = (Conv2d(s_ch, t_ch, 1, dtype=dtype, generator=generator)
                       if s_ch != t_ch else None)
            setattr(self, f"adapt_{tap}", adapter)

    def forward(self, tap: str, feat):
        adapter = getattr(self, f"adapt_{tap}")
        return adapter(feat) if adapter is not None else feat


def make_hint_adapters(student, teacher, taps: tuple[str, ...], *,
                       input_hw: tuple[int, int] = (65, 65), dtype=None,
                       generator=None) -> HintAdapters:
    """Build adapters from the tap widths of one small eval-mode forward of
    each model (their train/eval modes are restored afterwards)."""
    if not taps:
        return HintAdapters({}, dtype=dtype, generator=generator)
    chans = {}
    for side, model in enumerate((student, teacher)):
        was_training = model.training
        model.eval()
        p = next(model.parameters())
        x = torch.zeros((1, 3, *input_hw), device=p.device)
        with torch.no_grad():
            _, feats = model(x, return_features=True)
        model.train(was_training)
        for t in taps:
            chans.setdefault(t, [0, 0])[side] = feats[t].shape[1]
    return HintAdapters({t: tuple(c) for t, c in chans.items()}, dtype=dtype,
                        generator=generator)


def fused_loss_applicable(cfg: KDConfig) -> bool:
    """True when the fused CE + KL kernels cover this KD config."""
    return cfg.loss_type == "cross_entropy" and not cfg.kl_mask_ignored


def _hint_loss(cfg, student_taps, teacher_taps, adapters, device):
    l_hint = torch.zeros((), dtype=torch.float32, device=device)
    if not cfg.hint_taps:
        return l_hint
    refuse_under_ranks("the hint-L2 term")
    if student_taps is None or teacher_taps is None:
        raise ValueError("hint taps need the student's and teacher's "
                         "features")
    for tap in cfg.hint_taps:
        s, t = student_taps[tap], teacher_taps[tap]
        if adapters is not None:
            s = adapters(tap, s)
        if s.shape[-2:] != t.shape[-2:]:
            s = resize_bilinear(s, t.shape[-2:])
        l_hint = l_hint + hint_l2_loss(s, t)
    return l_hint


def kd_total_loss_small(s_small, t_small, labels, cfg: KDConfig, *,
                        student_taps: dict | None = None,
                        teacher_taps: dict | None = None,
                        adapters: HintAdapters | None = None):
    """KD loss from head-resolution class-major logits (N, C, h, w) and
    full-resolution labels (N, H, W). Returns (total, {'task', 'kd',
    'hint'}), all 0-d tensors on the logits' device. Under a group of more
    than one rank the fused loss is the global batch's
    (fused_ce_kl_loss_upsampled_sharded)."""
    out_h, out_w = labels.shape[1], labels.shape[2]
    total, l_task, l_kd = fused_ce_kl_loss_upsampled_sharded(
        s_small, t_small, labels, sharded_group(), out_h, out_w,
        cfg.temperature, cfg.alpha, cfg.beta, 255, cfg.teacher_logit_clip)
    l_hint = _hint_loss(cfg, student_taps, teacher_taps, adapters,
                        total.device)
    if cfg.hint_taps:
        total = total + cfg.gamma * l_hint
    return total, {"task": l_task, "kd": l_kd, "hint": l_hint}


def kd_total_loss(student_logits, teacher_logits, labels, cfg: KDConfig, *,
                  student_taps: dict | None = None,
                  teacher_taps: dict | None = None,
                  adapters: HintAdapters | None = None,
                  channel_axis: int = 1):
    """KD loss on full-resolution logits. Returns (total, {'task', 'kd',
    'hint'}). With class-major logits (channel_axis 1) and a config the
    fused kernels cover, the fused CE + KL (JAX distill.py:177-205), under a
    group of more than one rank the global batch's
    (fused_ce_kl_loss_sharded); the plain losses raise under ranks."""
    if channel_axis == 1 and fused_loss_applicable(cfg):
        total, l_task, l_kd = fused_ce_kl_loss_sharded(
            student_logits, teacher_logits, labels, sharded_group(),
            cfg.temperature, cfg.alpha, cfg.beta, 255,
            cfg.teacher_logit_clip)
        l_hint = _hint_loss(cfg, student_taps, teacher_taps, adapters,
                            total.device)
        if cfg.hint_taps:
            total = total + cfg.gamma * l_hint
        return total, {"task": l_task, "kd": l_kd, "hint": l_hint}
    refuse_under_ranks("the unfused KD loss (CE, focal, masked KL)")
    if cfg.teacher_logit_clip:
        c = float(cfg.teacher_logit_clip)
        teacher_logits = teacher_logits.clamp(-c, c)
    task_fn = focal_loss if cfg.loss_type == "focal_loss" else cross_entropy
    l_task = task_fn(student_logits, labels, channel_axis=channel_axis)
    l_kd = kd_kl_loss(student_logits, teacher_logits,
                      temperature=cfg.temperature,
                      labels=labels if cfg.kl_mask_ignored else None,
                      channel_axis=channel_axis)
    l_hint = _hint_loss(cfg, student_taps, teacher_taps, adapters,
                        l_task.device)
    total = cfg.alpha * l_task + cfg.beta * l_kd + cfg.gamma * l_hint
    return total, {"task": l_task, "kd": l_kd, "hint": l_hint}
