"""Cheap-conv replacement: build the student by swapping expensive convs of
a model for cheap ones (the JAX package's kd/replace.py).

`replace_cheap_convs` walks the model's modules and, for every eligible
`Conv2d` (kernel >= min_kernel, groups 1) inside `scope`, assigns a
replacement onto its parent. The replacement is initialised randomly or by
factorizing the dense kernel:

- separable: per-input-channel rank-1 SVD of the (kh*kw, Cout) slice, since
  the separable pair's effective kernel is W[kh,kw,ci,co] = D[kh,kw,ci]*P[ci,co];
- grouped: block-diagonal slice of the dense kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import Conv2d
from ..ops.separable import (SEP_MAX_K, fused_separable_conv,
                             supports_fused_separable)


@dataclasses.dataclass(frozen=True)
class CheapConvSpec:
    """What to replace an expensive conv with."""

    kind: str = "separable"   # 'separable' | 'grouped'
    groups: int = 4           # for kind='grouped'
    init: str = "factorize"   # 'factorize' | 'random'


class AtrousSeparableConvolution(nn.Module):
    """Depthwise kxk (inherits stride/padding/dilation) + pointwise 1x1,
    the cheap drop-in for a dense conv. Bias (if any) moves to the
    pointwise.

    A shape-preserving stride-1 pair (`supports_fused_separable`) whose
    channel counts the kernel takes (divisible by 8) runs through the fused
    separable conv (ops.separable), forward and backward, so the depthwise
    output never reaches device memory; any other runs its two convs."""

    def __init__(self, in_channels, out_channels, kernel_size, *, stride=1,
                 padding=0, dilation=1, use_bias=True, dtype=None,
                 generator=None):
        super().__init__()
        self.depthwise = Conv2d(in_channels, in_channels, kernel_size,
                                stride=stride, padding=padding,
                                dilation=dilation, groups=in_channels,
                                use_bias=False, dtype=dtype,
                                generator=generator)
        self.pointwise = Conv2d(in_channels, out_channels, 1,
                                use_bias=use_bias, dtype=dtype,
                                generator=generator)

    def fused_active(self) -> bool:
        dw, pw = self.depthwise, self.pointwise
        return (supports_fused_separable(
                    stride=dw.stride, padding=dw.padding,
                    dilation=dw.dilation, kernel_size=dw.kernel_size)
                and dw.kernel_size[0] <= SEP_MAX_K and dw.bias is None
                and dw.in_channels % 8 == 0 and pw.out_channels % 8 == 0)

    def forward(self, x):
        if not self.fused_active():
            return self.pointwise(self.depthwise(x))
        dw, pw = self.depthwise.weight, self.pointwise.weight
        dtype = self.depthwise.compute_dtype
        if dtype is not None:
            x, dw, pw = x.to(dtype), dw.to(dtype), pw.to(dtype)
        y = fused_separable_conv(x.permute(0, 2, 3, 1), dw, pw,
                                 self.depthwise.dilation[0])
        y = y.permute(0, 3, 1, 2)      # an NCHW view in channels_last memory
        if self.pointwise.bias is not None:
            y = y + self.pointwise.bias.to(y.dtype)[:, None, None]
        return y


def _factorize(kernel: np.ndarray):
    """Best rank-1-per-input-channel factorization of an HWIO kernel:
    W[kh,kw,ci,co] ~= D[kh,kw,ci] * P[ci,co] via batched SVD over ci.
    Returns (depthwise (kh,kw,1,ci), pointwise (1,1,ci,co))."""
    kh, kw, ci, co = kernel.shape
    mats = np.transpose(kernel, (2, 0, 1, 3)).reshape(ci, kh * kw, co)
    u, s, vt = np.linalg.svd(mats, full_matrices=False)
    s0 = np.sqrt(np.maximum(s[:, 0], 0.0))
    d = (u[:, :, 0] * s0[:, None]).reshape(ci, kh, kw)
    d = np.transpose(d, (1, 2, 0))[:, :, None, :]     # (kh, kw, 1, ci)
    p = (vt[:, 0, :] * s0[:, None])[None, None]       # (1, 1, ci, co)
    return d, p


def _hwio(w: torch.Tensor) -> np.ndarray:
    return w.detach().float().cpu().numpy().transpose(2, 3, 1, 0)


def _oihw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))


def _separable_from(conv: Conv2d, spec: CheapConvSpec, generator):
    new = AtrousSeparableConvolution(
        conv.in_channels, conv.out_channels, conv.kernel_size,
        stride=conv.stride, padding=conv.padding, dilation=conv.dilation,
        use_bias=conv.bias is not None, dtype=conv.compute_dtype,
        generator=generator)
    with torch.no_grad():
        if spec.init == "factorize":
            d, p = _factorize(_hwio(conv.weight))
            new.depthwise.weight.copy_(_oihw(d))
            new.pointwise.weight.copy_(_oihw(p))
        if conv.bias is not None:
            new.pointwise.bias.copy_(conv.bias)
    return new


def _grouped_from(conv: Conv2d, spec: CheapConvSpec, generator):
    g = spec.groups
    ci, co = conv.in_channels, conv.out_channels
    if ci % g or co % g:
        raise ValueError(f"groups={g} does not divide channels ({ci},{co})")
    new = Conv2d(ci, co, conv.kernel_size, stride=conv.stride,
                 padding=conv.padding, dilation=conv.dilation, groups=g,
                 use_bias=conv.bias is not None, dtype=conv.compute_dtype,
                 generator=generator)
    with torch.no_grad():
        if spec.init == "factorize":
            w = _hwio(conv.weight)                        # (kh,kw,ci,co)
            cig, cog = ci // g, co // g
            blocks = [w[:, :, j * cig:(j + 1) * cig, j * cog:(j + 1) * cog]
                      for j in range(g)]
            new.weight.copy_(_oihw(np.concatenate(blocks, axis=-1)))
        if conv.bias is not None:
            new.bias.copy_(conv.bias)
    return new


def replace_cheap_convs(
    model: nn.Module,
    spec: CheapConvSpec = CheapConvSpec(),
    *,
    scope: str | tuple[str, ...] | None = None,
    min_kernel: int = 2,
    generator: torch.Generator | None = None,
) -> list[str]:
    """Replace eligible convs in `model` (in place) per `spec`.

    Args:
      scope: dotted path prefix(es) ('backbone.features.3'); None = whole
        model.
      min_kernel: only convs with kernel >= this are replaced.
    Returns the dotted paths of the replaced convs. A replacement lands on
    the device and memory format of the conv it replaces.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    scopes = (scope,) if isinstance(scope, str) else scope
    replaced = []
    for path, m in list(model.named_modules()):
        if not isinstance(m, Conv2d):
            continue
        if max(m.kernel_size) < min_kernel or m.groups != 1:
            continue
        if scopes is not None and not any(
                path == s or path.startswith(s + ".") for s in scopes):
            continue
        if spec.kind == "separable":
            new = _separable_from(m, spec, generator)
        elif spec.kind == "grouped":
            new = _grouped_from(m, spec, generator)
        else:
            raise ValueError(f"unknown cheap-conv kind {spec.kind!r}")
        new = new.to(device=m.weight.device)
        if m.weight.is_contiguous(memory_format=torch.channels_last):
            new = new.to(memory_format=torch.channels_last)
        parent, _, name = path.rpartition(".")
        setattr(model.get_submodule(parent), name, new)
        replaced.append(path)
    return replaced


def convert_to_separable_conv(module: nn.Module, *,
                              generator: torch.Generator | None = None
                              ) -> nn.Module:
    """Reference-API shim: replace every conv with kernel>1 in `module` by an
    AtrousSeparableConvolution (random init, as the reference does)."""
    replace_cheap_convs(module, CheapConvSpec(kind="separable", init="random"),
                        min_kernel=2, generator=generator)
    return module
