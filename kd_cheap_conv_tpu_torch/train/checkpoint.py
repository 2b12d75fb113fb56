"""Checkpoints, the write side (the JAX package's train/checkpoint.py): the
reference's native `.pth` layout, `{cur_itrs, model_state, optimizer_state,
scheduler_state, best_score}`, under `latest_<model>_<dataset>_os<os>.pth`
and `best_...pth`. A KD run with hint adapters also stores their weights
under `adapters_state`. Reading a checkpoint back (`--ckpt`,
`--continue_training`) is not ported yet (ROADMAP.md, Queue 1 item 9).
"""

from __future__ import annotations

import os

import torch


def checkpoint_path(root: str, prefix: str, model: str, dataset: str,
                    output_stride: int) -> str:
    return os.path.join(os.path.abspath(root),
                        f"{prefix}_{model}_{dataset}_os{output_stride}.pth")


def save_checkpoint(path: str, *, cur_itrs: int, model, optimizer, scheduler,
                    best_score: float, adapters=None) -> None:
    """Write the five reference keys to `path` atomically (a temporary file
    in the same directory, then a rename)."""
    state = {
        "cur_itrs": int(cur_itrs),
        "model_state": model.state_dict(),
        "optimizer_state": optimizer.state_dict(),
        "scheduler_state": scheduler.state_dict(),
        "best_score": float(best_score),
    }
    if adapters is not None:
        state["adapters_state"] = adapters.state_dict()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
