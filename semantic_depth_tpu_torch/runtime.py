"""Device selection and numeric mode for the PyTorch port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do). A missing card raises instead of dropping quietly to the
CPU: a CPU run is never a measurement of the port.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when a CUDA device is asked for and
    none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def set_full_fp32() -> None:
    """Full-precision float32 convolutions and matrix products.

    cuDNN runs float32 convolutions in TF32 by default, and the resize and
    Gram-identity products lose digits below full float32. The port's
    default (``SemanticDepthPipeline`` calls this) matches the JAX tests'
    ``jax_default_matmul_precision="highest"``; TF32 is a later, opt-in
    change.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
