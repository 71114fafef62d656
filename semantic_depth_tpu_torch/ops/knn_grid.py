"""Windowed kNN mean distance on an image grid: hand-written CUDA kernel
(``csrc/knn_grid.cu``) and its plain PyTorch version.

Replaces ``semantic_depth_tpu/ops/pallas_knn.py`` (``_knn_tile_body`` in its
three kernels). For each valid pixel, the mean Euclidean distance to its k
nearest valid points in a (wh, ww) image window, self included at 0; +inf
for invalid pixels and for windows with fewer than k valid candidates.

The kernel stages each block's halo tile as one float4 a candidate (x, y,
z and w = 0 if valid, +inf if not), gives each thread two vertically
adjacent pixels, visits the window's offsets nearest first in an order
fixed at compile time and rejects a distance that cannot enter the k
smallest with one compare. The kept values are the multiset of the k
smallest whatever the order, so the result is bit-equal to the plain
version's; a block whose tile holds a valid point with a coordinate that
is not finite takes an exact path that keeps torch.topk's order of nan
after +inf.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _cuda

# the instantiation csrc/knn_grid.cu carries (the road chain's setting)
KERNEL_K, KERNEL_WINDOW = 10, (5, 21)


def knn_mean_distances_grid_plain(
    points: torch.Tensor, valid: torch.Tensor, k: int, window: Tuple[int, int] = (5, 21)
) -> torch.Tensor:
    """Plain PyTorch version: the stencil of all window offsets, the k
    smallest by ``topk``, square roots summed in ascending order like the
    kernel's sorted buffer. points (..., H, W, 3), valid (..., H, W)."""
    h, w = valid.shape[-2:]
    wh, ww = window
    ph, pw = wh // 2, ww // 2
    pts = torch.where(valid[..., None], points, 0.0).float()
    pad_pts = F.pad(pts, (0, 0, pw, pw, ph, ph))
    pad_valid = F.pad(valid.to(torch.uint8), (pw, pw, ph, ph)).bool()
    cx, cy, cz = pts.unbind(-1)
    cands = []
    for dy in range(wh):
        for dx in range(ww):
            sx, sy, sz = pad_pts[..., dy:dy + h, dx:dx + w, :].unbind(-1)
            ex, ey, ez = cx - sx, cy - sy, cz - sz
            d2 = ex * ex + ey * ey + ez * ez
            cands.append(torch.where(pad_valid[..., dy:dy + h, dx:dx + w], d2, float("inf")))
    smallest = torch.topk(torch.stack(cands, -1), k, dim=-1, largest=False, sorted=True).values
    # square roots via float64, which rounds to the correctly rounded float32
    # root (the kernel's __fsqrt_rn); torch's float32 CPU sqrt may be 1 ulp off
    roots = torch.sqrt(smallest.double()).float()
    acc = torch.zeros_like(cx)
    for j in range(k):
        acc = acc + roots[..., j]
    # a divisor on the same device: a CUDA tensor divided by a host scalar
    # is multiplied by its reciprocal instead (two roundings)
    return torch.where(valid, acc / acc.new_tensor(float(k)), float("inf"))


@torch.library.custom_op(f"{_cuda.NAMESPACE}::knn_grid", mutates_args=(), device_types="cpu")
def _knn_grid_op(points: torch.Tensor, valid: torch.Tensor, k: int,
                 window: Sequence[int]) -> torch.Tensor:
    """The dispatcher op; on the CPU, the plain version."""
    return knn_mean_distances_grid_plain(points, valid, k, tuple(window))


@_knn_grid_op.register_fake
def _(points, valid, k, window):
    return valid.new_empty(valid.shape, dtype=torch.float32)


@_knn_grid_op.register_kernel("cuda")
def _(points, valid, k, window):
    """The kernel: one launch for the batch, or raise."""
    if (k, tuple(window)) != (KERNEL_K, KERNEL_WINDOW):
        raise ValueError(
            f"the CUDA kernel is built for k={KERNEL_K}, window={KERNEL_WINDOW}; "
            f"got k={k}, window={tuple(window)}"
        )
    if points.ndim != 4 or points.shape[-1] != 3:
        raise ValueError(f"points must be (B, H, W, 3), got {tuple(points.shape)}")
    b, h, w, _ = points.shape
    _cuda.require(points, "points", torch.float32)
    _cuda.require(valid, "valid", torch.bool, (b, h, w))
    out = torch.empty((b, h, w), dtype=torch.float32, device=points.device)
    if out.numel() == 0:
        return out
    lib = _cuda.library()
    err = lib.sd_knn_grid(
        points.data_ptr(), valid.data_ptr(), out.data_ptr(), b, h, w, k,
        window[0], window[1], _cuda.stream_ptr(points),
    )
    _cuda.check(err, "knn_mean_distances_grid")
    knn_mean_distances_grid.launches += 1
    return out


def knn_mean_distances_grid(
    points: torch.Tensor, valid: torch.Tensor, k: int, window: Tuple[int, int] = (5, 21)
) -> torch.Tensor:
    """points (B, H, W, 3) float32, valid (B, H, W) bool -> (B, H, W)
    float32, through the op ``sd_torch::knn_grid``: CPU tensors take the
    plain version; CUDA tensors launch the kernel (one launch for the
    batch, counted in ``launches``) or raise."""
    return _knn_grid_op(points, valid, k, list(window))


knn_mean_distances_grid.launches = 0
