"""The yardstick's arithmetic: peaks, the kernels' bounds, the step's work.

Frozen copies of the port's chip smoke arithmetic (``bound_ms``,
``knn_grid_bound``, the K2 and K3 bounds of ``phase_kernels`` and
``radius_pairs``), computed from the inputs the kernels were given: the
valid points, the rows and the capacity. A bound is the larger of the
bytes over the HBM rate and the float32 operations over the float32 rate.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch

# one H100 SXM (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

# the port's kernels by their device names (semantic_depth_tpu_torch/csrc)
KERNELS = {"K1": ("knn_grid_kernel", "knn_grid_general_kernel"),
           "K2": ("mad_cluster_kernel",),
           "K3": ("radius_prep_kernel", "radius_kernel")}


def kernel_of(name: str):
    """K1, K2 or K3 for a device kernel's name, else None."""
    for key, names in KERNELS.items():
        if any(re.search(rf"(^|[\s:]){n}($|[<(\s])", name) for n in names):
            return key
    return None


def bound_ms(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def knn_grid_work(valid: torch.Tensor, k: int = 10, window=(5, 21)) -> Tuple[float, float]:
    """K1 on (B, H, W) valid pixels: each point read (12 + 1 bytes) and each
    mean written (4) once; 9 float32 operations a (valid pixel, valid
    candidate) pair, and 2k + 1 for each valid pixel with k candidates."""
    b, h, w = valid.shape
    wh, ww = window
    cand = torch.nn.functional.conv2d(
        valid.float()[:, None], torch.ones((1, 1, wh, ww), device=valid.device),
        padding=(wh // 2, ww // 2))[:, 0, :h, :w]
    n_ops = (float((cand * valid).sum()) * 9.0
             + float((valid & (cand >= k)).sum()) * (2.0 * k + 1))
    return b * h * w * (12 + 1 + 4), n_ops


def mad_work(elements: float) -> Tuple[float, float]:
    """K2 over ``elements`` row values: 4 + 1 bytes read and 1 written a
    value; 37 operations a value."""
    return elements * (4 + 1 + 1), elements * 37.0


def radius_pairs(xyz: torch.Tensor, valid: torch.Tensor, r: float) -> float:
    """The (valid query, valid candidate) pairs with |dz| within the radius
    widened by the Gram identity's float32 error, sqrt(r^2 + 4e-6 max|p|^2)."""
    x, y, z = xyz.unbind(-1)
    sq = x * x + y * y + z * z
    zthr = torch.sqrt(float(r) ** 2 + 4e-6 * torch.where(valid, sq, 0.0).amax(-1))
    needed = 0
    for f in range(valid.shape[0]):
        zs = torch.sort(z[f][valid[f]]).values
        lo = torch.searchsorted(zs, zs - zthr[f])
        hi = torch.searchsorted(zs, zs + zthr[f], right=True)
        needed += int((hi - lo).sum())
    return float(needed)


def radius_work(xyz: torch.Tensor, valid: torch.Tensor, r: float) -> Tuple[float, float]:
    """K3 on (B, C) clouds: points, validity, weights read and sums written
    once; 10 operations a needed pair."""
    b, c = valid.shape
    return b * c * (12 + 1 + 4 + 4), radius_pairs(xyz, valid, r) * 10.0


def kernel_work(tail: Dict, cfg: Dict) -> Dict[str, Tuple[float, float]]:
    """(bytes, operations) of K1, K2 and K3 on the inputs of one reference
    tail (``reference.frame.tail``): what the program's tail gave them."""
    road = cfg["road"]
    return {"K1": knn_grid_work(tail["knn_valid"], road["stat_k"], tuple(road["stat_window"])),
            "K2": mad_work(float(sum(tail["mad_elements"]))),
            "K3": radius_work(tail["packed_xyz"], tail["packed_valid"], road["radius"])}


def resize_flop(frame_hw, out_hw) -> float:
    """The resize's two float32 products a frame (none at the same size)."""
    (sh, sw), (h, w) = frame_hw, out_hw
    if (sh, sw) == (h, w):
        return 0.0
    return 2.0 * h * sh * sw * 3 + 2.0 * h * 3 * sw * w
