"""Optimizer: SGD (momentum 0.9, weight decay 1e-4 on every parameter) with
the reference's two parameter groups, backbone at 1x LR and everything else
(head, hint adapters) at `head_lr_mult` x, and PolyLR or the step policy
through a LambdaLR (the JAX package's train/optim.py).

torch's SGD order is the reference's: grad += wd * p, then the momentum
buffer v = mu * v + grad, then p -= lr * v. The JAX package's flat-vector
"fused SGD" reproduces this order with an XLA layout trick; it computes the
same update and is not ported.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def poly_lambda(max_iters: int, power: float = 0.9) -> Callable[[int], float]:
    """lr factor (1 - step/max_iters)^power, clipped at 0 (reference PolyLR)."""
    def fn(step: int) -> float:
        return min(max(1.0 - step / max_iters, 0.0), 1.0) ** power
    return fn


def step_lambda(step_size: int, gamma: float = 0.1) -> Callable[[int], float]:
    """lr factor gamma^(step // step_size) (reference --lr_policy step)."""
    def fn(step: int) -> float:
        return gamma ** (step // step_size)
    return fn


def _group(name: str) -> str:
    return "backbone" if name.startswith("backbone.") else "head"


def make_optimizer(
    named_params: Iterable[tuple[str, torch.nn.Parameter]],
    *,
    lr: float = 0.01,
    max_iters: int = 30_000,
    power: float = 0.9,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    head_lr_mult: float = 10.0,
    lr_policy: str = "poly",
    step_size: int = 10_000,
    step_gamma: float = 0.1,
):
    """Returns (torch.optim.SGD, LambdaLR) over `named_params` (dotted name,
    parameter): names under 'backbone.' get 1x LR, every other name
    head_lr_mult x. Step the scheduler once after each optimizer step."""
    groups = {"backbone": [], "head": []}
    for name, p in named_params:
        if p.requires_grad:
            groups[_group(name)].append(p)
    param_groups = [{"params": groups["backbone"], "lr": lr},
                    {"params": groups["head"], "lr": lr * head_lr_mult}]
    opt = torch.optim.SGD([g for g in param_groups if g["params"]], lr=lr,
                          momentum=momentum, weight_decay=weight_decay)
    factor = (step_lambda(step_size, step_gamma) if lr_policy == "step"
              else poly_lambda(max_iters, power))
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
