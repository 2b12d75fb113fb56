"""JAX model leaves -> a torch state_dict of the port's model.

The port's module paths equal the JAX model's NNX paths, so a leaf keyed
'backbone.features.0.conv.kernel' maps to 'backbone.features.0.conv.weight'.
Counterpart of the JAX package's train/checkpoint.py
`import_torch_state_dict`, in the other direction.
"""

from __future__ import annotations

import numpy as np
import torch

# JAX leaf name -> torch name
_LEAF = {
    "kernel": "weight",          # conv, HWIO -> OIHW
    "scale": "weight",           # BatchNorm affine
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def state_dict_from_jax(params: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Map the JAX model's leaves, keyed by dotted NNX path, to torch names.

    Strict: a leaf name without a mapping, a conv kernel that is not 4-D, or
    two leaves landing on one torch key raises. Each BatchNorm (found by its
    'var' leaf) also gets num_batches_tracked = 0, so the result loads with
    `load_state_dict(strict=True)`.
    """
    out: dict[str, torch.Tensor] = {}

    def put(key, value):
        if key in out:
            raise KeyError(f"two JAX leaves map to {key!r}")
        out[key] = value

    for path, arr in params.items():
        prefix, _, leaf = path.rpartition(".")
        if leaf not in _LEAF or not prefix:
            raise KeyError(f"unmapped JAX leaf {path!r}")
        a = np.asarray(arr)
        if leaf == "kernel":
            if a.ndim != 4:
                raise ValueError(f"{path}: expected an HWIO conv kernel, "
                                 f"got shape {a.shape}")
            a = a.transpose(3, 2, 0, 1)
        put(f"{prefix}.{_LEAF[leaf]}", torch.from_numpy(np.array(a, order="C")))
        if leaf == "var":
            put(f"{prefix}.num_batches_tracked",
                torch.tensor(0, dtype=torch.long))
    return out
