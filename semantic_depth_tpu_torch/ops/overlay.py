"""Segmentation overlay composition (port of ``semantic_depth_tpu/ops/overlay.py``).

The reference pastes an RGBA mask with PIL (semantic_depth.py:555-569):
``out = round(frame * (255 - a) / 255 + color * a / 255)`` per channel,
road first, fence second, materialising uint8 after EVERY paste. The
reference pastes RGB tuples onto BGR frames without conversion; the quirk is
kept by working on whatever channel order the caller supplies.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..runtime import device_constant


def _paste(frame: torch.Tensor, mask: torch.Tensor, rgba: Tuple[int, int, int, int]) -> torch.Tensor:
    # constants kept on the frame's device (no copy from the host); alpha is
    # float32 a / 255 as JAX computes it (a CUDA tensor divided by a host
    # scalar would be multiplied by the reciprocal instead)
    color = device_constant(tuple(float(c) for c in rgba[:3]), frame.device)
    alpha = device_constant(float(np.float32(rgba[3]) / np.float32(255.0)), frame.device)
    blended = frame * (1.0 - alpha) + color * alpha
    # round after each paste: rounding once at the end drifts 1 LSB on the
    # road-and-fence overlap pixels
    blended = torch.clamp(torch.round(blended), 0.0, 255.0)
    return torch.where(mask[..., None], blended, frame)


def segmentation_overlay(
    frame: torch.Tensor,
    road_mask: torch.Tensor,
    fence_mask: torch.Tensor,
    road_rgba: Tuple[int, int, int, int],
    fence_rgba: Tuple[int, int, int, int],
) -> torch.Tensor:
    """frame: (..., H, W, 3) float 0..255; masks: (..., H, W) bool. Returns
    float32 0..255, rounded to integers after each paste."""
    out = torch.clamp(torch.round(frame.float()), 0.0, 255.0)
    out = _paste(out, road_mask, road_rgba)
    return _paste(out, fence_mask, fence_rgba)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """cv2.COLOR_RGB2GRAY weights (the masked gray sanity images,
    semantic_depth.py:172-174)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=rgb.device)
    return torch.clamp(torch.round(rgb.float() @ w), 0.0, 255.0)
