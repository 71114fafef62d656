"""Map the JAX package's flax parameters onto the port's ``state_dict``s.

Input is the flax variable tree as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``), so this module needs no JAX.

* ``nn.Conv`` kernels are HWIO; torch ``Conv2d`` weights are OIHW.
* ``nn.ConvTranspose(transpose_kernel=True)`` kernels are TF's
  (kh, kw, out, in); torch ``ConvTranspose2d`` weights are (in, out, kh, kw)
  and compute the same gradient-of-conv, so only the axes move.

Both are ``permute(3, 2, 0, 1)``. Biases carry over as they are.
``flax_from_module`` maps the other way, for writing weight files that the
JAX package reads. ``adam_state_from_optax`` and ``optax_from_adam_state``
carry an ``optax.adam`` state (``ScaleByAdamState``: ``count``, and ``mu`` /
``nu`` in the flax layout) to torch Adam's per-parameter ``step`` /
``exp_avg`` / ``exp_avg_sq`` and back, by the same permutation.
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


def flax_from_module(module: torch.nn.Module) -> Dict[str, Any]:
    """The inverse of ``state_dict_from_flax``: ``{"params": {layer:
    {"kernel", "bias"}}}`` of float32 numpy arrays, kernels back in flax's
    layout (``permute(2, 3, 1, 0)``)."""
    return _flax_tree(module.state_dict().items())


def _flax_tree(named_tensors) -> Dict[str, Any]:
    """``(name, tensor)`` pairs keyed as the module's parameters -> a flax
    variable tree of float32 numpy arrays."""
    params: Dict[str, Any] = {}
    for name, tensor in named_tensors:
        layer, kind = name.rsplit(".", 1)
        t = tensor.detach().float().cpu()
        leaf = t.permute(2, 3, 1, 0).contiguous() if kind == "weight" else t
        params.setdefault(layer, {})["kernel" if kind == "weight" else "bias"] = leaf.numpy()
    return {"params": params}


def _adam_leaf(opt_state) -> Any:
    """The ``ScaleByAdamState`` inside ``optax.adam``'s chain state (or the
    state itself)."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    for part in opt_state:
        if all(hasattr(part, k) for k in ("count", "mu", "nu")):
            return part
    raise ValueError("no Adam state (count, mu, nu) in this optimizer state")


def adam_state_from_optax(opt_state, module: torch.nn.Module) -> Dict[int, Dict[str, torch.Tensor]]:
    """An ``optax.adam`` state as the ``"state"`` entry of a torch Adam
    ``state_dict`` over ``module.parameters()`` (one group, keys the
    parameters' indices). Leaves may be JAX or numpy arrays."""
    adam = _adam_leaf(opt_state)
    mu = state_dict_from_flax(adam.mu)
    nu = state_dict_from_flax(adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)))
    return {i: {"step": step.clone(), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
            for i, (name, _) in enumerate(module.named_parameters())}


def optax_from_adam_state(state: Mapping[int, Mapping[str, torch.Tensor]],
                          module: torch.nn.Module) -> Dict[str, Any]:
    """The inverse: ``{"count", "mu", "nu"}`` with ``mu`` / ``nu`` flax
    variable trees of float32 numpy arrays, from a torch Adam
    ``state_dict()["state"]`` over ``module.parameters()``."""
    names = [name for name, _ in module.named_parameters()]
    trees = {key: _flax_tree((name, state[i][field]) for i, name in enumerate(names))
             for key, field in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}
    return {"count": np.int32(int(state[0]["step"])), **trees}
