"""Exact kNN mean distance over a masked cloud: hand-written CUDA kernel
(``csrc/exact_knn.cu``) and its plain PyTorch version.

Replaces ``semantic_depth_tpu/ops/pallas_exact_knn.py::knn_mean_distances_exact_pallas``
(``_exact_knn_kernel``). For each valid row of each frame, the mean
Euclidean distance to its min(k, n) nearest valid points of the frame: the
row itself counts at distance 0, coincident points count once each, and
the mean divides by the number found (Open3D's SearchKNN returns fewer than
k on a cloud smaller than k). +inf on invalid rows.

d2 = max(|q|^2 + |c|^2 - 2 q.c, 0) in float32 (the Gram identity, never
``torch.cdist``), with the cross term as three products and two sums in
``ops/radius.py``'s order. A nan d2 (only from non-finite valid points) is
never a neighbour. Kernel and plain version take the same float32 steps, so
their results are bit-equal on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from .pcl import valid_span

KERNEL_MAX_K = 32  # csrc/exact_knn.cu instantiates k = 1 .. 32
_PLAIN_BLOCK = 1024  # candidates per step of the plain version (bounds its memory)


def knn_mean_distances_exact_plain(xyz: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version over candidate blocks: each block's k smallest
    (``topk``), merged into the running k smallest. xyz (..., C, 3), valid
    (..., C) -> (..., C) float32. Rows past the last valid one
    (``pcl.valid_span``) are +inf without being searched."""
    c = valid.shape[-1]
    n = valid_span(valid)
    valid = valid[..., :n]
    pts = torch.where(valid[..., None], xyz[..., :n, :], 0.0).float()
    px, py, pz = pts.unbind(-1)
    sq = px * px + py * py + pz * pz
    inf = float("inf")
    best = torch.full(valid.shape + (k,), inf, device=xyz.device)
    for j0 in range(0, n, _PLAIN_BLOCK):
        sl = slice(j0, j0 + _PLAIN_BLOCK)
        cross = (px[..., :, None] * px[..., None, sl] + py[..., :, None] * py[..., None, sl]
                 + pz[..., :, None] * pz[..., None, sl])
        d2 = torch.clamp_min((sq[..., :, None] + sq[..., None, sl]) - 2.0 * cross, 0.0)
        d2 = torch.where(valid[..., None, sl] & ~torch.isnan(d2), d2, inf)
        blk = torch.topk(d2, min(k, d2.shape[-1]), dim=-1, largest=False, sorted=True).values
        best = torch.sort(torch.cat([best, blk], -1), dim=-1).values[..., :k]
    fin = torch.isfinite(best)  # ascending: the finite min(k, n) lead
    # square roots via float64, which rounds to the correctly rounded float32
    # root (the kernel's __fsqrt_rn); torch's float32 CPU sqrt may be 1 ulp off
    roots = torch.where(fin, torch.sqrt(best.double()).float(), 0.0)
    acc = torch.zeros_like(sq)
    for j in range(k):
        acc = acc + roots[..., j]
    cnt = torch.clamp_min(fin.sum(-1).float(), 1.0)
    return F.pad(torch.where(valid, acc / cnt, inf), (0, c - n), value=inf)


def knn_mean_distances_exact(xyz: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """xyz (B, C, 3) float32, valid (B, C) bool -> (B, C) float32, any C.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (grid (ceil(C/128), B), one launch per batch) or raise."""
    if xyz.device.type == "cpu":
        return knn_mean_distances_exact_plain(xyz, valid, k)
    if not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(f"the CUDA kernel is built for 1 <= k <= {KERNEL_MAX_K}; got k={k}")
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be (B, C, 3), got {tuple(xyz.shape)}")
    b, c, _ = xyz.shape
    _cuda.require(xyz, "xyz", torch.float32)
    _cuda.require(valid, "valid", torch.bool, (b, c))
    out = torch.empty((b, c), dtype=torch.float32, device=xyz.device)
    if out.numel() == 0:
        return out
    lib = _cuda.library()
    err = lib.sd_exact_knn(xyz.data_ptr(), valid.data_ptr(), out.data_ptr(), b, c, k,
                           _cuda.stream_ptr(xyz))
    _cuda.check(err, "knn_mean_distances_exact")
    knn_mean_distances_exact.launches += 1
    return out


knn_mean_distances_exact.launches = 0
