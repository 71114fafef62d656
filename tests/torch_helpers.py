"""Shared helpers of the ``test_torch_*`` files: parameters for the JAX and
PyTorch networks made from a numpy seed, so both sides see the same weights,
and both sides' parameters as flat dicts in flax's layout."""

import jax
import jax.numpy as jnp
import numpy as np


def numpy_params(module, *inputs, seed=0, method=None):
    """A flax variable tree for ``module`` with numpy-seeded weights.

    Shapes come from ``jax.eval_shape`` (no init compile, which costs tens
    of seconds on the CPU); kernels are normal with std 1/sqrt(fan-in), so
    activations keep their scale through the depth, and biases are small."""
    rng = np.random.default_rng(seed)
    kw = {} if method is None else {"method": method}
    shapes = jax.eval_shape(
        lambda *xs: module.init(jax.random.PRNGKey(0), *xs, **kw),
        *[jnp.asarray(x) for x in inputs],
    )

    def fill(leaf):
        shape = leaf.shape
        if len(shape) == 4:  # HWIO conv or (kh, kw, out, in) transposed conv
            std = 1.0 / np.sqrt(shape[0] * shape[1] * shape[2])
        else:
            std = 0.05
        return rng.normal(0.0, std, size=shape).astype(np.float32)

    return jax.tree.map(fill, shapes)


def flax_flat(tree):
    """A flax variable tree as {"layer.kernel" / "layer.bias": numpy array}."""
    return {f"{layer}.{kind}": np.asarray(v) for layer, leaf in tree["params"].items()
            for kind, v in leaf.items()}


def port_flat(module, grads=False):
    """A torch module's parameters (or their gradients) keyed and laid out
    as ``flax_flat`` gives the flax tree's."""
    out = {}
    for name, p in module.named_parameters():
        t = (p.grad if grads else p).detach()
        layer, kind = name.rsplit(".", 1)
        out[f"{layer}.{'kernel' if kind == 'weight' else 'bias'}"] = (
            t.permute(2, 3, 1, 0) if kind == "weight" else t).numpy()
    return out
