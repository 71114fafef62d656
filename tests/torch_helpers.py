"""Shared helpers of the ``test_torch_*`` files: parameters for the JAX and
PyTorch networks made from a numpy seed, so both sides see the same weights."""

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
