"""Space-to-depth and its inverse on NHWC tensors (port of ``space_to_depth`` /
``depth_to_space`` in ``semantic_depth_tpu/ops/s2d.py``).

Channels are phase-major: output channel ``(di * r + dj) * C + c`` holds
``x[r*i + di, r*j + dj, c]``. ``torch.nn.functional.pixel_unshuffle`` and
``pixel_shuffle`` order channels channel-major (``c * r*r + di * r + dj``),
so they would scramble the ``input_s2d`` networks' first and last layers;
plain reshape and permute keep the JAX layout. The JAX module's convolution
rewrites (``s2d_conv``, ``upconv_s2d``) are TPU lowerings with no
counterpart here.
"""

from __future__ import annotations

import torch


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/r, W/r, r*r*C), phase-major channels."""
    b, h, w, c = x.shape
    if h % r or w % r:
        raise ValueError(f"space_to_depth needs H, W % {r} == 0, got {h}x{w}")
    x = x.reshape(b, h // r, r, w // r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // r, w // r, r * r * c)


def depth_to_space(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Inverse of ``space_to_depth``: (B, H, W, r*r*C) -> (B, r*H, r*W, C)."""
    b, hc, wc, cc = x.shape
    if cc % (r * r):
        raise ValueError(f"depth_to_space needs channels % {r * r} == 0, got {cc}")
    c = cc // (r * r)
    x = x.reshape(b, hc, wc, r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hc * r, wc * r, c)
