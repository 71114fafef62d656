"""Weighted radius neighbour counts: hand-written CUDA kernel (``csrc/radius.cu``)
and its plain PyTorch version.

Replaces ``semantic_depth_tpu/ops/pallas_exact_knn.py::radius_counts_pallas``
(``_radius_kernel``). For each valid query of each frame, the sum of the
weights of the frame's candidates with d2 < r^2 (strict; FLANN's
RadiusResultSet), where d2 = max(|q|^2 + |c|^2 - 2 q.c, 0) in float32; 0 on
invalid rows. The Gram identity (never ``torch.cdist``) keeps the
reference's rounding.

Kernel and plain version write the cross term as three products and two
sums in the same order, and the squared norms likewise, without fused
multiply-adds, so their counts are bit-equal on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from .pcl import valid_span

_TILE = 128  # csrc/radius.cu: queries per block, candidates per tile
_PLAIN_BLOCK = 1024  # candidates per step of the plain version (bounds its memory)


def _prepare(xyz: torch.Tensor, valid: torch.Tensor, weights: torch.Tensor, radius: float,
             skip: bool):
    """Kernel inputs, as pallas_exact_knn.py:162-202 builds them:
    candidates zeroed with weight 0 where invalid; invalid query rows take
    the frame's first valid point (a real point keeps the tile z-range tight
    and never nan); per-tile valid-z ranges widened by
    sqrt(r^2 + 4e-6 * max|p|^2), the radius plus the Gram identity's float32
    error bound, so a skipped tile provably holds no neighbour."""
    b, c = valid.shape
    w = torch.where(valid, weights.float(), 0.0)
    cands = torch.where(valid[..., None], xyz, 0.0).float()
    first = valid.int().argmax(-1)  # row 0 when a frame has no valid row
    fill = xyz.gather(1, first[:, None, None].expand(b, 1, 3))
    queries = torch.where(valid[..., None], xyz, fill).float()
    sq = (xyz * xyz).sum(-1)
    maxsq = torch.where(valid, sq, 0.0).amax(-1, keepdim=True)
    zthr = torch.sqrt(torch.tensor(float(radius), device=xyz.device) ** 2 + 4e-6 * maxsq)
    if not skip:  # validation: disable tile skipping
        zthr = torch.full_like(zthr, float("inf"))
    zc = xyz[..., 2].reshape(b, c // _TILE, _TILE)
    vb = valid.reshape(b, c // _TILE, _TILE)
    bz = torch.cat([
        torch.where(vb, zc, float("inf")).amin(-1) - zthr,
        torch.where(vb, zc, float("-inf")).amax(-1) + zthr,
    ], dim=-1)  # (B, 2 * n_tiles): lows then highs
    return queries.contiguous(), cands.contiguous(), w.contiguous(), bz.contiguous()


def radius_counts_plain(
    xyz: torch.Tensor, valid: torch.Tensor, weights: torch.Tensor, radius: float
) -> torch.Tensor:
    """Plain PyTorch version over candidate blocks (no z-range skipping: the
    skip is exact, so the result is the same). Rows past the last valid one
    (``pcl.valid_span``) count 0 without being searched."""
    c = valid.shape[-1]
    n = valid_span(valid)
    valid = valid[..., :n]
    xyz = xyz[..., :n, :]
    w = torch.where(valid, weights[..., :n].float(), 0.0)
    cands = torch.where(valid[..., None], xyz, 0.0).float()
    qx, qy, qz = xyz.float().unbind(-1)
    cx, cy, cz = cands.unbind(-1)
    sq_q = qx * qx + qy * qy + qz * qz
    sq_c = cx * cx + cy * cy + cz * cz
    r2 = float(radius) ** 2
    acc = torch.zeros_like(sq_q)
    for j0 in range(0, n, _PLAIN_BLOCK):
        sl = slice(j0, j0 + _PLAIN_BLOCK)
        cross = (qx[..., None] * cx[:, None, sl] + qy[..., None] * cy[:, None, sl]
                 + qz[..., None] * cz[:, None, sl])
        d2 = torch.clamp_min((sq_q[..., None] + sq_c[:, None, sl]) - 2.0 * cross, 0.0)
        acc += torch.where(d2 < r2, w[:, None, sl], 0.0).sum(-1)
    return F.pad(torch.where(valid, acc, 0.0), (0, c - n))


def radius_counts(
    xyz: torch.Tensor, valid: torch.Tensor, weights: torch.Tensor, radius: float,
    skip: bool = True,
) -> torch.Tensor:
    """xyz (B, C, 3) float32, valid (B, C) bool, weights (B, C) float32 ->
    (B, C) float32 weighted counts. CPU tensors take the plain version; CUDA
    tensors launch the kernel (grid (C/128, B), one launch per batch) or
    raise. ``skip=False`` turns the z-range tile skip off."""
    if xyz.device.type == "cpu":
        return radius_counts_plain(xyz, valid, weights, radius)
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be (B, C, 3), got {tuple(xyz.shape)}")
    b, c, _ = xyz.shape
    if c % _TILE:
        raise ValueError(f"capacity {c} must be a multiple of {_TILE}")
    _cuda.require(xyz, "xyz", torch.float32)
    _cuda.require(valid, "valid", torch.bool, (b, c))
    _cuda.require(weights, "weights", torch.float32, (b, c))
    out = torch.empty((b, c), dtype=torch.float32, device=xyz.device)
    if out.numel() == 0:
        return out
    queries, cands, w, bz = _prepare(xyz, valid, weights, radius, skip)
    lib = _cuda.library()
    err = lib.sd_radius_counts(
        queries.data_ptr(), cands.data_ptr(), w.data_ptr(), bz.data_ptr(), out.data_ptr(),
        b, c, float(radius) ** 2, _cuda.stream_ptr(xyz),
    )
    _cuda.check(err, "radius_counts")
    radius_counts.launches += 1
    return torch.where(valid, out, 0.0)


radius_counts.launches = 0
