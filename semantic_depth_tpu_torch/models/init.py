"""Parameter initializers of the JAX package's networks, for torch modules.

flax initializes every ``nn.Conv`` kernel with ``lecun_normal()`` (a normal
truncated at +-2 sigma, rescaled so that the kept values have variance
1 / fan-in) and every bias with zeros; FCN-8s's decoder kernels take
``truncated_normal(0.01)`` instead, a normal of std 0.01 cut at +-2 sigma
(``semantic_depth_tpu/models/fcn8s.py:94``). PyTorch's default init is
neither. The draws come from the given ``torch.Generator`` (the global
stream when it is None); they cannot equal flax's, only their law can.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling constant)
_TRUNC_STD = 0.87962566103423978


def _truncated_normal_(t: torch.Tensor, std: float, generator: Optional[torch.Generator]):
    """A normal of std ``std`` before the cut at +-2 std."""
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def lecun_normal_(layer: nn.Module, generator: Optional[torch.Generator] = None,
                  fan_in: Optional[int] = None) -> None:
    """flax ``lecun_normal()`` kernel and zero bias (where it has one) for a
    ``Conv2d`` or ``Linear`` (OIHW or (out, in): fan-in = I * H * W, as
    flax's HWIO kernel counts it), or with the ``fan_in`` given."""
    fan_in = layer.weight[0].numel() if fan_in is None else fan_in
    _truncated_normal_(layer.weight, (1.0 / fan_in) ** 0.5 / _TRUNC_STD, generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


def truncated_normal_(layer: nn.Module, std: float,
                      generator: Optional[torch.Generator] = None) -> None:
    """flax ``truncated_normal(std)`` kernel and zero bias."""
    _truncated_normal_(layer.weight, std, generator)
    nn.init.zeros_(layer.bias)
