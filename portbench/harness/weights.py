"""Seeded network weights, made on the device in the type they are served in.

One normal draw from a ``torch.Generator`` on the device covers every
weight of a network; each layer's slice is cut at +-2 and scaled to its
law (flax's ``lecun_normal``: std 1 / sqrt(fan-in) over the truncated
normal's std; FCN-8s's decoder: 0.01), biases zero. The tensors are keyed
as the reference's layers, which are the port's parameter names.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..reference.nets import Layer

_TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at +-2


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
