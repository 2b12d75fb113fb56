"""The cache of the eval kernels' folded weights, shared by every fold of
the port (ops/irchain_eval.py, ops/tstem.py, ops/rchain.py,
ops/xchain_eval.py).

A fold (eval BNs folded into the weights of the convs they follow) is
computed once and kept on the module that owns it, until one of the tensors
it reads is replaced, moved or updated in place: the key is the dtype and
each tensor's device, data pointer and version counter. A teacher folds
once; a student's validation folds again after each optimizer step.
"""

from __future__ import annotations

import torch


def cached_fold(mod, attr, tensors, dtype, build):
    """build() under no_grad, cached on mod.<attr> until one of `tensors`
    changes (see the module docstring)."""
    key = (dtype, *((t.device, t.data_ptr(), t._version) for t in tensors))
    hit = getattr(mod, attr, None)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        val = build()
    setattr(mod, attr, (key, val))
    return val
