"""Weighted radius neighbour counts: hand-written CUDA kernels (``csrc/radius.cu``)
and their plain PyTorch versions.

Replaces ``semantic_depth_tpu/ops/pallas_exact_knn.py::radius_counts_pallas``
(``_radius_kernel``). For each valid query of each frame, the sum of the
weights of the frame's candidates with d2 < r^2 (strict; FLANN's
RadiusResultSet), where d2 = max(|q|^2 + |c|^2 - 2 q.c, 0) in float32; 0 on
invalid rows. The Gram identity (never ``torch.cdist``) keeps the
reference's rounding.

Kernel and plain version write the cross term as three products and two
sums in the same order, and the squared norms likewise, without fused
multiply-adds, so each pair counts in both or in neither, and where the
weighted sums are exact in float32 (integer or dyadic weights) the counts
are bit-equal on the card. The kernel adds its candidate splits' sums in a
fixed order, so its counts are the same on every run whatever the weights.
On the card the wrapper allocates and launches, and at the road chain's
capacities nothing else (another capacity is padded to the kernel's tiles
first, see ``kernel_layout``): a preparation kernel computes the z-ranges
that ``subtile_ranges`` computes here, and the count kernel skips, per warp
of queries, every subtile whose range misses them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..runtime import annotate
from . import _cuda
from .pcl import valid_span

# csrc/radius.cu's constants
SUBTILE = 32  # candidates per z-range
TILE = 128  # candidates per staged tile; the kernel's capacity is a multiple
QUERIES_PER_THREAD = 2  # consecutive queries of a thread
WARP_QUERIES = 32 * QUERIES_PER_THREAD  # the queries whose z-range a warp tests
BLOCK_QUERIES = 4 * WARP_QUERIES
MAX_SPLITS = 16  # interleaved shares of the candidate tiles (at most C // TILE)
MAX_FRAMES = 65535  # frames a launch (the grid's y extent)
_PLAIN_BLOCK = 1024  # candidates per step of the plain version (bounds its memory)


def subtile_ranges(xyz: torch.Tensor, valid: torch.Tensor, radius: float) -> torch.Tensor:
    """Plain version of the preparation kernel: (B, C, 3), (B, C) -> (B, 2,
    C // SUBTILE) float32, each subtile's valid-z range (lows, then highs)
    widened by sqrt(r^2 + 4e-6 * max|p|^2), the radius plus the Gram
    identity's float32 error bound (pallas_exact_knn.py:162-202), so a
    skipped subtile provably holds no neighbour. An empty subtile gets
    (+inf, -inf); nan coordinates are left out (a nan pair never counts)."""
    b, c = valid.shape
    x, y, z = xyz.float().unbind(-1)
    sq = x * x + y * y + z * z
    maxsq = torch.where(valid & ~sq.isnan(), sq, 0.0).amax(-1, keepdim=True)
    zthr = torch.sqrt(float(radius) ** 2 + 4e-6 * maxsq)
    ok = (valid & ~z.isnan()).reshape(b, -1, SUBTILE)
    zs = z.reshape(b, -1, SUBTILE)
    lo = torch.where(ok, zs, float("inf")).amin(-1) - zthr
    hi = torch.where(ok, zs, float("-inf")).amax(-1) + zthr
    return torch.stack([lo, hi], dim=1)


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


def scratch_words(b: int, c: int) -> int:
    """float32 words of the kernels' scratch: the subtile ranges (B, 2,
    C // SUBTILE), the splits' sums (S, B, C) and one int32 ticket per frame
    and query block (S = min(MAX_SPLITS, C // TILE), as the kernel takes)."""
    splits = min(MAX_SPLITS, c // TILE)
    return b * (2 * (c // SUBTILE) + splits * c + -(-c // BLOCK_QUERIES))


def kernel_layout(xyz: torch.Tensor, valid: torch.Tensor, weights: torch.Tensor):
    """(xyz, valid, weights) as the kernels take them: a capacity that is a
    multiple of ``TILE`` (at least one tile), contiguous. The inputs
    themselves where they already are (no copy: the road chain's
    capacities); else fresh copies whose padded rows are invalid with
    weight 0. An invalid candidate adds nothing to a count and an invalid
    query counts 0, so the first C rows' counts are those of the
    unpadded cloud."""
    b, c = valid.shape
    cp = max(TILE, -(-c // TILE) * TILE)
    if cp == c and all(t.is_contiguous() for t in (xyz, valid, weights)):
        return xyz, valid, weights
    xyz_k = xyz.new_zeros((b, cp, 3))
    valid_k = valid.new_zeros((b, cp))
    weights_k = weights.new_zeros((b, cp))
    xyz_k[:, :c] = xyz
    valid_k[:, :c] = valid
    weights_k[:, :c] = weights
    return xyz_k, valid_k, weights_k


def _launch(xyz, valid, weights, radius, skip, scratch, out) -> None:
    """The two kernels on checked tensors; the subtile ranges land in the
    first B * 2 * (C // SUBTILE) words of ``scratch``."""
    b, c = valid.shape
    err = _cuda.library().sd_radius_counts(
        xyz.data_ptr(), valid.data_ptr(), weights.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        b, c, float(radius) ** 2, int(skip), _cuda.stream_ptr(xyz),
    )
    _cuda.check(err, "radius_counts")


@torch.library.custom_op(f"{_cuda.NAMESPACE}::radius_counts", mutates_args=(),
                         device_types="cpu")
def _radius_op(xyz: torch.Tensor, valid: torch.Tensor, weights: torch.Tensor, radius: float,
               skip: bool) -> torch.Tensor:
    """The dispatcher op; on the CPU, the plain version (its ``valid_span``
    reads the data: the op is opaque to an export)."""
    return radius_counts_plain(xyz, valid, weights, radius)


@_radius_op.register_fake
def _(xyz, valid, weights, radius, skip):
    return valid.new_empty(valid.shape, dtype=torch.float32)


@_radius_op.register_kernel("cuda")
def _(xyz, valid, weights, radius, skip):
    """The two kernels, or raise. A capacity off the kernel's tiles is padded
    (see ``kernel_layout``) and the counts sliced back; the frames go in
    chunks of at most ``MAX_FRAMES``, one launch each."""
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be (B, C, 3), got {tuple(xyz.shape)}")
    b, c, _ = xyz.shape
    for t, name in ((valid, "valid"), (weights, "weights")):
        if tuple(t.shape) != (b, c):
            raise ValueError(f"{name} must have shape {(b, c)}, got {tuple(t.shape)}")
        if t.device != xyz.device:
            raise ValueError(f"xyz and {name} must be on one device")
    xyz_k, valid_k, weights_k = kernel_layout(xyz, valid, weights)
    _cuda.require(xyz_k, "xyz", torch.float32)
    _cuda.require(valid_k, "valid", torch.bool)
    _cuda.require(weights_k, "weights", torch.float32)
    cp = valid_k.shape[1]
    out = torch.empty((b, cp), dtype=torch.float32, device=xyz.device)
    if b * c == 0:
        return out[:, :c]
    scratch = torch.empty(scratch_words(min(b, MAX_FRAMES), cp), dtype=torch.float32,
                          device=xyz.device)
    for f0, n in _cuda.launch_chunks(b, MAX_FRAMES, "radius"):
        f = slice(f0, f0 + n)
        _launch(xyz_k[f], valid_k[f], weights_k[f], radius, skip, scratch, out[f])
    return out if cp == c else out[:, :c].contiguous()


def radius_counts(
    xyz: torch.Tensor, valid: torch.Tensor, weights: torch.Tensor, radius: float,
    skip: bool = True,
) -> torch.Tensor:
    """xyz (B, C, 3) float32, valid (B, C) bool, weights (B, C) float32 ->
    (B, C) float32 weighted counts, through the op ``sd_torch::radius_counts``.
    CPU tensors take the plain version; CUDA tensors launch the kernels (one
    preparation block per frame, then grid (C / BLOCK_QUERIES, B,
    min(MAX_SPLITS, C / TILE)); one launch per ``MAX_FRAMES`` frames, counted
    in ``_cuda.launches``) at any B and C, or raise on a wrong rank or dtype.
    ``skip=False`` turns the z-range skip off."""
    with annotate("sd.k3", xyz.is_cuda):
        return _radius_op(xyz, valid, weights, float(radius), bool(skip))
