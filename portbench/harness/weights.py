"""Seeded network weights, made on the device in the type they are served in.

One normal draw from a ``torch.Generator`` on the device covers every
weight of a network; each layer's slice is cut at +-2 and scaled to its
law (flax's ``lecun_normal``: std 1 / sqrt(fan-in) over the truncated
normal's std; FCN-8s's decoder: 0.01), biases zero. The tensors are keyed
as the reference's layers, which are the port's parameter names.

The cut clamps at +-2 rather than drawing again, so a layer's weights
have std about 1.09 / sqrt(fan-in); the layer laws stay so, since every
cell's weights are drawn by them.

A reference that lists its ``Param``s (``nets.network``'s ``params``) gets
``make_params``: one normal draw over the parameters whose law draws
(``lecun``, ``normal``), in list order, each slice clamped at +-2 and
scaled by its law's std over the clamped normal's, so that it has that
std; ``zeros`` and ``ones`` take no draw.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from ..reference.nets import Layer, Param

_TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at +-2
# std of a unit normal clamped at +-2: E[x^2; |x| < 2] = erf(sqrt 2) - 4 phi(2), and 4 beyond
_CLAMPED_STD = math.sqrt(4 - 3 * math.erf(2 ** 0.5) - 4 * math.exp(-2) / math.sqrt(2 * math.pi))


def make(layers: List[Layer], gen: torch.Generator, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    dev = gen.device
    sizes = [int(torch.Size(layer.weight_shape).numel()) for layer in layers]
    draw = torch.randn(sum(sizes), generator=gen, device=dev).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for layer, n in zip(layers, sizes):
        if layer.init == "decoder":
            std = 0.01
        else:  # fan-in of a convolution's (out, in, k, k) weight
            std = (1.0 / (layer.cin * layer.k * layer.k)) ** 0.5 / _TRUNC_STD
        out[f"{layer.name}.weight"] = (draw[at:at + n] * std).to(dtype).view(layer.weight_shape)
        out[f"{layer.name}.bias"] = torch.zeros(layer.cout, dtype=dtype, device=dev)
        at += n
    return out


def make_params(params: List[Param], gen: torch.Generator,
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The weights that ``params`` list, keyed by their names."""
    dev = gen.device
    drawn = [p for p in params if p.law not in ("zeros", "ones")]
    draw = torch.randn(sum(math.prod(p.shape) for p in drawn), generator=gen,
                       device=dev).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for p in params:
        if p.name in out:
            raise ValueError(f"the parameter {p.name} is listed twice")
        if p.law in ("zeros", "ones"):
            fill = torch.zeros if p.law == "zeros" else torch.ones
            out[p.name] = fill(p.shape, dtype=dtype, device=dev)
            continue
        n = math.prod(p.shape)
        std = (1.0 / p.fan_in) ** 0.5 if p.law == "lecun" else p.std
        out[p.name] = (draw[at:at + n] * (std / _CLAMPED_STD)).to(dtype).view(p.shape)
        at += n
    return out
