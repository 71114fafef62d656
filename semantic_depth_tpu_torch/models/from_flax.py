"""Map the JAX package's flax parameters onto the port's ``state_dict``s.

Input is the flax variable tree as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.

* ``nn.Conv`` kernels are HWIO; torch ``Conv2d`` weights are OIHW.
* ``nn.ConvTranspose(transpose_kernel=True)`` kernels are TF's
  (kh, kw, out, in); torch ``ConvTranspose2d`` weights are (in, out, kh, kw)
  and compute the same gradient-of-conv, so only the axes move.

Both are ``permute(3, 2, 0, 1)``. Biases carry over as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``{"params": {layer: {"kernel", "bias"}}}`` -> ``{"layer.weight",
    "layer.bias"}``. Every layer of both networks is a 4-D conv or
    transposed-conv kernel, and both map by the same axis permutation."""
    params = variables.get("params", variables)
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in params.items():
        kernel = _tensor(leaf["kernel"])
        if kernel.ndim != 4:
            raise ValueError(f"{name}: expected a 4-D kernel, got {tuple(kernel.shape)}")
        out[f"{name}.weight"] = kernel.permute(3, 2, 0, 1).contiguous()
        out[f"{name}.bias"] = _tensor(leaf["bias"])
    return out


def load_flax(module: torch.nn.Module, variables: Mapping[str, Any]) -> torch.nn.Module:
    """Load flax parameters into ``module`` (strict: every key must match).
    The tensors are cast to the module's dtype and device on copy."""
    module.load_state_dict(state_dict_from_flax(variables), strict=True)
    return module
