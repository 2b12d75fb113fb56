"""Training loop and validate (the JAX package's train/loop.py): the
reference main.py's iteration-based loop, print and val intervals,
latest/best checkpoints on val mIoU, and a 'latest' checkpoint on SIGTERM.

The loop body stays thin: one step per iteration on device batches; the
metrics are read back to the host only at print intervals.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass
from typing import Callable, Iterator

import torch

from ..parallel.mesh import all_reduce_sum, rank, sharded_group, world_size
from ..utils.metrics import AverageMeter, StreamSegMetrics
from .checkpoint import checkpoint_path, save_checkpoint
from .steps import TrainState, make_eval_step


@dataclass
class LoopConfig:
    total_itrs: int = 30_000
    print_interval: int = 10
    val_interval: int = 100
    ckpt_dir: str = "checkpoints"
    model_name: str = "model"
    dataset_name: str = "dataset"
    output_stride: int = 16


def validate(model, loader: Iterator, *, num_classes: int,
             eval_step=None) -> dict:
    """Run eval over a loader of device batches (images NCHW, labels NHW);
    returns the StreamSegMetrics results dict. The confusion matrix is
    summed in int64 on the device and read back once at the end. Under a
    group of more than one rank each rank evaluates its rows (the eval
    kernels carry no batch statistics, as the JAX `maybe_shard_eval`) and
    the matrices are all-reduced, so every rank returns the global
    results."""
    model.eval()
    if eval_step is None:
        eval_step = make_eval_step(model, num_classes=num_classes)
    cm = None
    for images, labels in loader:
        counts, _ = eval_step(images, labels)
        cm = counts if cm is None else cm + counts
    if cm is None:
        cm = torch.zeros((num_classes, num_classes), dtype=torch.long,
                         device=next(model.parameters()).device)
    all_reduce_sum(cm, sharded_group())
    return StreamSegMetrics.from_confusion_matrix(cm.cpu().numpy())


def _save(state: TrainState, cfg: LoopConfig, prefix: str,
          best_score: float) -> str | None:
    """Write a checkpoint (rank 0 only under a group); returns its path."""
    if rank(sharded_group()) != 0:
        return None
    path = checkpoint_path(cfg.ckpt_dir, prefix, cfg.model_name,
                           cfg.dataset_name, cfg.output_stride)
    save_checkpoint(path, cur_itrs=state.step, model=state.model,
                    optimizer=state.optimizer, scheduler=state.scheduler,
                    best_score=best_score, adapters=state.adapters)
    return path


def train_loop(*, state: TrainState, step_fn: Callable, train_iter: Iterator,
               cfg: LoopConfig,
               validate_fn: Callable[[TrainState], dict] | None = None,
               log_fn: Callable[[str], None] = print
               ) -> tuple[TrainState, float]:
    """Run `step_fn(*batch)` until cfg.total_itrs, a batch being (images,
    labels) or, cached-teacher, (images, labels, teacher logits). Returns
    (state, best_score).

    At each print interval: the metrics and a windowed img/s (that
    interval's steps only, so the first window's warm-up does not hide the
    steady rate). At each val interval and at the end: the 'latest'
    checkpoint, then `validate_fn(state)` (a dict with 'Mean IoU') and the
    'best' checkpoint when it improves. On SIGTERM the loop stops after the
    current step and writes 'latest'.

    Under a group of more than one rank every rank runs the loop and
    validates (validate_fn all-reduces); rank 0 alone writes checkpoints
    and logs the rest, while every rank logs its metric lines: they are
    the global batch's, equal on every rank, so a rank that diverged shows.
    """
    group = sharded_group()
    main_rank, ranks = rank(group) == 0, world_size(group)
    meter = AverageMeter()
    best_score = 0.0
    stop = {"sigterm": False}

    def _on_sigterm(signum, frame):
        stop["sigterm"] = True

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        prev_handler = None  # not in the main thread: no handler
    t_last = time.perf_counter()
    try:
        while state.step < cfg.total_itrs and not stop["sigterm"]:
            try:
                batch = next(train_iter)
            except StopIteration:
                if main_rank:
                    log_fn("train iterator exhausted before total_itrs")
                break
            metrics = step_fn(*batch)
            images = batch[0]
            state.step += 1
            cur = state.step

            if cur % cfg.print_interval == 0:
                values = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                step_s = (now - t_last) / cfg.print_interval
                meter.update(step_s, cfg.print_interval)
                t_last = now
                # 9 significant digits: an f32 metric round-trips, so two
                # runs (or ranks) print the same line only for the same bits
                parts = ", ".join(f"{k}={v:.9g}" for k, v in values.items())
                log_fn(f"Itrs {cur}/{cfg.total_itrs}: {parts} "
                       f"({images.shape[0] * ranks / max(step_s, 1e-9):.1f}"
                       f" img/s)")

            if cur % cfg.val_interval == 0 or cur >= cfg.total_itrs:
                _save(state, cfg, "latest", best_score)
                if validate_fn is not None:
                    results = validate_fn(state)
                    if main_rank:
                        log_fn(StreamSegMetrics.to_str(results))
                    if results["Mean IoU"] > best_score:
                        best_score = results["Mean IoU"]
                        _save(state, cfg, "best", best_score)
                t_last = time.perf_counter()

        if stop["sigterm"]:
            _save(state, cfg, "latest", best_score)
            if main_rank:
                log_fn(f"SIGTERM: checkpoint written at itrs {state.step}; "
                       f"exiting")
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
    return state, best_score
