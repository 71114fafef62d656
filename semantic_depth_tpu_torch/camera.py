"""Pinhole back-projection: disparity map -> 3D point cloud.

Port of ``semantic_depth_tpu/camera.py``: ``cv2.reprojectImageTo3D(disp, Q)``
with the reference's hand-built Q matrix (semantic_depth.py:691-697), i.e.

    X = (x - cx) * b / d,   Y = (cy - y) * b / d,   Z = -f * b / d

Where d == 0 the result is +-inf exactly as OpenCV leaves it; those points
reach the filters, which drop them.
"""

from __future__ import annotations

import torch

from .config import CameraConfig
from .runtime import device_constant


def reproject_disparity(disp: torch.Tensor, camera: CameraConfig) -> torch.Tensor:
    """disp: (..., H, W) disparities in pixels (already multiplied by the
    disparity multiplier). Returns (..., H, W, 3) float32 points."""
    h, w = disp.shape[-2:]
    disp = disp.float()
    xs = torch.arange(w, dtype=torch.float32, device=disp.device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=disp.device)[:, None]
    # b / d as a true division: ``float / tensor`` in torch is
    # reciprocal-then-multiply, which rounds twice; b is a constant kept on
    # the disparity's device (no copy from the host)
    inv_w = torch.div(device_constant(camera.baseline, disp.device), disp)
    x3 = (xs - camera.cx) * inv_w
    y3 = (camera.cy - ys) * inv_w
    z3 = (-camera.focal) * inv_w
    return torch.stack([x3, y3, z3], dim=-1)
