"""Train, KD and eval steps (the JAX package's train/steps.py).

The KD step is config #2's hot loop: the frozen eval-mode teacher's forward
under no_grad, the train-mode student's forward and backward, the loss, one
SGD step and one scheduler step. With the fused loss (cross-entropy KD, the
default) both models return head-resolution class-major logits and the
upsample happens inside the loss kernels. The steps update the models, the
optimizer and the scheduler in place and return their metrics as 0-d
tensors on the device: nothing in a step reads a value back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kd.distill import (KDConfig, fused_loss_applicable, kd_total_loss,
                          kd_total_loss_small, refuse_under_ranks)
from ..ops.losses import focal_loss
from ..ops.losses_fused import fused_ce_loss_upsampled
from ..parallel.mesh import allreduce_grads, sharded_group


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds: the trained model (the student in KD), its
    optimizer and scheduler, the hint adapters if any, and the step count
    (the reference's cur_itrs). The step functions update the first four in
    place; the training loop advances `step`."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    adapters: torch.nn.Module | None = None
    step: int = 0


def _update(loss, optimizer, scheduler):
    """Backward, then under a group of more than one rank the SUM of the
    ranks' gradients (one flat all-reduce): the loss is the global one, so
    each rank's gradients are its share of the global gradient (a DDP-style
    average would be W times too small). Then one optimizer step."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    allreduce_grads([p for g in optimizer.param_groups for p in g["params"]],
                    sharded_group())
    optimizer.step()
    if scheduler is not None:
        scheduler.step()


def make_train_step(model, optimizer, scheduler=None, *,
                    loss_type: str = "cross_entropy"):
    """Supervised step: (images NCHW, labels NHW int64) -> {'loss'}. For
    cross-entropy the loss is the fused upsample + CE (the beta = 0 instance
    of the KD loss kernels) on head-resolution logits."""
    if loss_type not in ("cross_entropy", "focal_loss"):
        raise ValueError(f"unknown loss_type {loss_type!r}")

    def step_fn(images, labels):
        model.train()
        if loss_type == "cross_entropy":
            small = model(images, class_major=True, upsample=False)
            loss = fused_ce_loss_upsampled(small, labels, labels.shape[1],
                                           labels.shape[2],
                                           group=sharded_group())
        else:
            refuse_under_ranks("the focal loss")
            loss = focal_loss(model(images, class_major=True), labels,
                              channel_axis=1)
        _update(loss, optimizer, scheduler)
        return {"loss": loss.detach()}

    return step_fn


def make_kd_train_step(student, teacher, optimizer, cfg: KDConfig,
                       scheduler=None, *, adapters=None,
                       cached_teacher: bool = False):
    """KD step -> {'loss', 'task', 'kd', 'hint'}.

    With a live teacher the step takes (images NCHW, labels NHW int64); the
    teacher runs in eval mode without autograd, and the fused loss takes
    the head-resolution logits when `fused_loss_applicable(cfg)`, else
    `kd_total_loss` takes upsampled ones. With `cached_teacher` (config #1)
    it takes (images, labels, teacher logits NHWC from the cache) and no
    teacher; the student's full-resolution logits go to `kd_total_loss`
    (the fused full-resolution CE + KL where it applies). The student (and
    the hint adapters) train."""
    if cached_teacher and cfg.hint_taps:
        raise ValueError("cached-teacher mode caches logits only; hint taps "
                         "need a live teacher")
    if not cached_teacher and teacher is None:
        raise ValueError("teacher required unless cached_teacher=True")
    use_up = not cached_teacher and fused_loss_applicable(cfg)
    need_taps = bool(cfg.hint_taps)
    if not cached_teacher:
        teacher.eval()

    def step_fn(images, labels, t_logits=None):
        student.train()
        if adapters is not None:
            adapters.train()
        if cached_teacher:
            if t_logits is None:
                raise ValueError("the cached-teacher step takes (images, "
                                 "labels, teacher logits)")
            # cached logits arrive NHWC: an NCHW view, read as stored
            t_logits, t_taps = t_logits.permute(0, 3, 1, 2), None
        else:
            with torch.no_grad():
                t_out = teacher(images, return_features=need_taps,
                                class_major=True, upsample=not use_up)
            t_logits, t_taps = t_out if need_taps else (t_out, None)
        s_out = student(images, return_features=need_taps, class_major=True,
                        upsample=not use_up)
        s_logits, s_taps = s_out if need_taps else (s_out, None)
        loss_fn = kd_total_loss_small if use_up else kd_total_loss
        loss, aux = loss_fn(s_logits, t_logits, labels, cfg,
                            student_taps=s_taps, teacher_taps=t_taps,
                            adapters=adapters)
        _update(loss, optimizer, scheduler)
        return {"loss": loss.detach(),
                **{k: v.detach() for k, v in aux.items()}}

    return step_fn


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
