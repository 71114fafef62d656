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

The road chain's (k, window) = (KERNEL_K, KERNEL_WINDOW) launches a kernel
specialised at compile time. Every other pair the plain version takes
(1 <= k <= wh * ww, any window) launches the general kernel: the same
scheme with the block shape from ``general_block``, the visiting order from
``general_order`` passed as a table of halo offsets (no row test in its
loops), and the k smallest in registers up to k = 32; above, the 32
smallest in registers and the other k - 32 unsorted in shared memory, their
largest tracked (``csrc/kselect.cuh``). Both count in ``launches``; the general kernel
also in ``general_launches``. The frames go in chunks of at most
``MAX_FRAMES``, one launch each.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..runtime import annotate
from . import _cuda

# the specialised kernel of csrc/knn_grid.cu (the road chain's setting)
KERNEL_K, KERNEL_WINDOW = 10, (5, 21)
REGISTER_MAX_K = 32  # the general kernel keeps up to this many in registers
ROWS = 2  # vertically adjacent pixels a thread
# the general kernel's block shapes (threads across, thread rows), largest
# first: the first whose shared memory fits is taken
GENERAL_BLOCKS = ((32, 8), (32, 4), (32, 2), (32, 1), (16, 1), (8, 1), (4, 1), (2, 1), (1, 1))
SMEM_OPTIN_BYTES = _cuda.SMEM_OPTIN_BYTES
MAX_FRAMES = 65535  # frames a launch (the grid's z extent)


def visit_order(window: Tuple[int, int]) -> List[Tuple[int, int]]:
    """The kernels' visiting order: the union of a thread's two windows as
    (dy, dx) from its first pixel (dy in -(wh // 2) .. wh - wh // 2, dx in
    -(ww // 2) .. ww - 1 - ww // 2), nearest to the two pixels' midpoint
    first: key (2 dy - 1)^2 + 4 dx^2, ties by dy, then dx. The specialised
    kernel's compile-time ``Order`` is this at (5, 21)."""
    wh, ww = window
    ph, pw = wh // 2, ww // 2
    offsets = [(dy, dx) for dy in range(-ph, wh - ph + ROWS - 1) for dx in range(-pw, ww - pw)]
    return sorted(offsets, key=lambda o: ((2 * o[0] - ROWS + 1) ** 2 + 4 * o[1] ** 2,) + o)


def general_order(window: Tuple[int, int]):
    """The general kernel's visiting order: ``visit_order`` cut into three
    parts, each nearest first: the offsets in both pixels' windows (dy in
    -(wh // 2) + 1 .. wh - 1 - wh // 2), the first pixel's top row (dy =
    -(wh // 2)), the second pixel's bottom row (dy = wh - wh // 2)."""
    wh, ww = window
    top, bottom = -(wh // 2), wh - wh // 2
    order = visit_order(window)
    return ([o for o in order if top < o[0] < bottom], [o for o in order if o[0] == top],
            [o for o in order if o[0] == bottom])


@functools.lru_cache(maxsize=None)
def _order_table(window: Tuple[int, int], tx: int, device: torch.device) -> torch.Tensor:
    """``general_order`` as the kernel reads it: one int32 a candidate, its
    offset dy * (tx + ww - 1) + dx in the halo tile of a block tx threads
    wide, on ``device``; built once per window, block width and card."""
    sw = tx + window[1] - 1
    packed = [dy * sw + dx for part in general_order(window) for dy, dx in part]
    return torch.tensor(packed, dtype=torch.int32).to(device)


def general_block(k: int, window: Tuple[int, int], smem_limit: int = SMEM_OPTIN_BYTES):
    """(threads across, thread rows, dynamic shared memory bytes) of the
    general kernel's block: the first of ``GENERAL_BLOCKS`` whose float4
    halo (2 ty + wh - 1) x (tx + ww - 1), and for k > ``REGISTER_MAX_K``
    its buffers of the values past the registers (2 tx ty (k - 32)
    floats), fit in ``smem_limit`` bytes. Raises
    ValueError, naming the limit, where not even one thread's fits."""
    wh, ww = window
    for tx, ty in GENERAL_BLOCKS:
        smem = (ROWS * ty + wh - 1) * (tx + ww - 1) * 16
        if k > REGISTER_MAX_K:
            smem += ROWS * tx * ty * (k - REGISTER_MAX_K) * 4
        if smem <= smem_limit:
            return tx, ty, smem
    raise ValueError(
        f"window {tuple(window)} with k={k}: one thread's halo and buffers need {smem} bytes of "
        f"shared memory, over the card's {smem_limit} bytes a block")


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
    """The kernel, one launch per ``MAX_FRAMES`` frames, or raise."""
    window = tuple(window)
    wh, ww = window
    if wh < 1 or ww < 1 or not 1 <= k <= wh * ww:
        raise ValueError(f"need 1 <= k <= wh * ww; got k={k}, window={window}")
    if points.ndim != 4 or points.shape[-1] != 3:
        raise ValueError(f"points must be (B, H, W, 3), got {tuple(points.shape)}")
    b, h, w, _ = points.shape
    _cuda.require(points, "points", torch.float32)
    _cuda.require(valid, "valid", torch.bool, (b, h, w))
    out = torch.empty((b, h, w), dtype=torch.float32, device=points.device)
    if out.numel() == 0:
        return out
    lib = _cuda.library()
    stream = _cuda.stream_ptr(points)
    general = (k, window) != (KERNEL_K, KERNEL_WINDOW)
    if general:
        tx, ty, smem = general_block(k, window, _cuda.smem_limit(points.device))
        order = _order_table(window, tx, points.device)
    plane = h * w
    p, v, o = points.data_ptr(), valid.data_ptr(), out.data_ptr()
    for f0 in range(0, b, MAX_FRAMES):  # frame f0 on: float32 points (3 a pixel), bool, float32
        n = min(MAX_FRAMES, b - f0)
        at = f0 * plane
        if general:
            err = lib.sd_knn_grid_general(p + 12 * at, v + at, o + 4 * at, order.data_ptr(),
                                          order.numel(), n, h, w, k, wh, ww, tx, ty, smem, stream)
            _cuda.check(err, "knn_mean_distances_grid (general)")
            knn_mean_distances_grid.general_launches += 1
        else:
            err = lib.sd_knn_grid(p + 12 * at, v + at, o + 4 * at, n, h, w, k, wh, ww, stream)
            _cuda.check(err, "knn_mean_distances_grid")
        knn_mean_distances_grid.launches += 1
    return out


def knn_mean_distances_grid(
    points: torch.Tensor, valid: torch.Tensor, k: int, window: Tuple[int, int] = (5, 21)
) -> torch.Tensor:
    """points (B, H, W, 3) float32, valid (B, H, W) bool -> (B, H, W)
    float32, through the op ``sd_torch::knn_grid``: CPU tensors take the
    plain version; CUDA tensors launch a kernel (one launch per
    ``MAX_FRAMES`` frames, counted in ``launches``; the general kernel's
    also in ``general_launches``) at any B, or raise."""
    with annotate("sd.k1", points.is_cuda):
        return _knn_grid_op(points, valid, k, list(window))


knn_mean_distances_grid.launches = 0
knn_mean_distances_grid.general_launches = 0
