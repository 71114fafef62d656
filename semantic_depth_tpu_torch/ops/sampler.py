"""Horizontal bilinear warp sampler (monodepth's ``bilinear_sampler_1d_h``).

Port of ``semantic_depth_tpu/ops/sampler.py``. The sampler displaces along x
only::

    out[b, y, x] = I[b, y, x + d[b, y, x] * W]   (d in width-normalized units)

``border`` (the published mode): the image gets a one-pixel zero pad,
sample coordinates shift by +1 into the padded frame and are clipped to
``[0, W + 1]``, and ``x1 = min(x0 + 1, W + 1)``; samples just past the border
blend toward zero, samples beyond the pad are zero. ``edge`` clamps to
``[0, W - 1]``.

The two taps are ``torch.gather`` on the W axis. Its backward on the card
adds with atomics, so sampler gradients there are not bit-reproducible.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``. At a value equal to a
    bound JAX's max and min give each side half the gradient, as
    ``torch.maximum`` / ``torch.minimum`` do; ``torch.clamp`` would pass it
    whole."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def bilinear_sample_x(img: torch.Tensor, x_offset: torch.Tensor,
                      wrap_mode: str = "border") -> torch.Tensor:
    """Sample ``img`` (B, H, W, C) at x' = x + x_offset * W, ``x_offset``
    (B, H, W) normalized (positive samples to the right). Returns
    (B, H, W, C)."""
    b, h, w, c = img.shape
    xs = torch.arange(w, dtype=torch.float32, device=img.device)
    sample_x = xs + x_offset * float(w)
    if wrap_mode == "border":
        edge = 1
        img = F.pad(img, (0, 0, edge, edge))
        sample_x = sample_x + edge
        wp = w + 2 * edge  # padded width
        sample_x = clip(sample_x, 0.0, float(w - 1 + 2 * edge))
    elif wrap_mode == "edge":
        wp = w
        sample_x = clip(sample_x, 0.0, float(w - 1))
    else:
        raise ValueError(f"unknown wrap_mode {wrap_mode!r}")
    x0 = torch.floor(sample_x)
    frac = sample_x - x0  # == x - x0_f; the left weight x1_f - x = 1 - frac
    x0i = x0.long()
    x1i = torch.clamp(x0i + 1, max=wp - 1)

    def take(idx):
        return torch.gather(img, 2, idx[..., None].expand(b, h, w, c))

    return take(x0i) * (1.0 - frac)[..., None] + take(x1i) * frac[..., None]


def warp_right_to_left(right_img: torch.Tensor, left_disp: torch.Tensor) -> torch.Tensor:
    """Reconstruct the left view: sample the right image at x - d_L(x)."""
    return bilinear_sample_x(right_img, -left_disp)


def warp_left_to_right(left_img: torch.Tensor, right_disp: torch.Tensor) -> torch.Tensor:
    """Reconstruct the right view: sample the left image at x + d_R(x)."""
    return bilinear_sample_x(left_img, right_disp)
