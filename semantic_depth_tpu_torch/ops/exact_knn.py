"""Exact kNN mean distance over a masked cloud: hand-written CUDA kernels
(``csrc/exact_knn.cu``) and their plain PyTorch version.

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

The kernels visit only part of the pairs: a preparation kernel computes the
axis-aligned box of every 32-candidate subtile and of every group of 32
subtiles (``subtile_boxes`` here), and the search walks each warp's near
field first and skips what provably holds no neighbour. The result does not
depend on which candidates are skipped or in what order the rest are
visited (the kept values are the multiset of the k smallest), so skipping
changes no bit. ``skip=False`` scans every candidate in row order.

For k > ``REGISTER_MAX_K`` the k smallest do not fit in registers: two
other kernels run the same schedule with each query's buffer in shared
memory: its 32 smallest in registers as the walks keep theirs, the other
k - 32 unsorted in shared memory with their largest tracked
(``csrc/kselect.cuh``; ``large_k_layout`` picks the warps a block, and past
k = 934 the scratch holds them); and a deferred
query's far walk searches again from its near walk's k-th distance, merging
the warp's candidates into its k smallest by rank. Their launches count in
``_cuda.launches`` under ``exact_knn`` and ``exact_knn.large_k``.

The frames go in chunks of at most ``MAX_FRAMES`` whose padded rows stay
below 2^31 (the kernels' row ids are 32-bit), one launch each.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..runtime import annotate
from . import _cuda
from .pcl import valid_span

REGISTER_MAX_K = 32  # the walks of csrc/exact_knn.cu take k = 1 .. 32; above: the large-k walks
# csrc/exact_knn.cu's constants
SUBTILE = 32  # candidates per box
GROUP = 32  # subtiles per group box (1024 candidates)
QUERIES_PER_THREAD = 2
WARP_QUERIES = 32 * QUERIES_PER_THREAD  # the queries whose skip a warp votes on
BLOCK_QUERIES = 4 * WARP_QUERIES
# the skip margin (csrc/exact_knn.cu derives it): a candidate c is skipped
# for a query q only if its box's squared distance exceeds
# thr * (1 + MARGIN_THR) + MARGIN_SQ * (|q|^2 + max |c|^2 over the box)
MARGIN_SQ = 2.0 ** -19
MARGIN_THR = 2.0 ** -20
# after its own group, a query whose k-th distance has a binary exponent more
# than DEFER_EXP above its warp's mean leaves the warp: a second kernel
# finishes it with the warp's 32 lanes over the candidates
DEFER_EXP = 2
STATS = ("pairs_near", "pairs_far", "subtiles_loaded", "subtile_tests", "deferred")
MAX_FRAMES = 65535  # frames a launch (the grid's y extent)
MAX_ROWS = 2 ** 31 - 1  # padded rows (B * 32 S) a launch: the deferred list's row ids
FAR_BLOCKS = 264  # csrc/exact_knn.cu's far walks: blocks of 4 warps
LK_PENDING = 512  # the large-k far walk's pending values a warp
SMEM_OPTIN_BYTES = _cuda.SMEM_OPTIN_BYTES
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


def _sizes(c: int):
    """(subtiles S, padded capacity 32 S, groups G) of a capacity C."""
    s = -(-c // SUBTILE)
    return s, s * SUBTILE, -(-s // GROUP)


def subtile_boxes(xyz: torch.Tensor, valid: torch.Tensor):
    """Plain version of the preparation kernel's boxes: (B, C, 3), (B, C) ->
    (subtiles (B, S, 8), groups (B, G, 8)) float32, S = ceil(C / SUBTILE),
    G = ceil(S / GROUP). Each row is (lo x, lo y, lo z, m, hi x, hi y, hi z,
    0): the box of the valid rows without a nan coordinate, and m their
    largest |p|^2 (the skip margin's scale; +inf if one is infinite). An
    empty box is (+inf, -inf) with m = 0. A group's box bounds its subtiles'."""
    b, c = valid.shape
    s, cp, g = _sizes(c)
    x = F.pad(xyz.float(), (0, 0, 0, cp - c))
    ok = F.pad(valid, (0, cp - c)) & ~x.isnan().any(-1)
    px, py, pz = x.unbind(-1)
    sq = px * px + py * py + pz * pz
    inf = float("inf")
    lo = torch.where(ok[..., None], x, inf).reshape(b, s, SUBTILE, 3).amin(2)
    hi = torch.where(ok[..., None], x, -inf).reshape(b, s, SUBTILE, 3).amax(2)
    m = torch.where(ok, sq, 0.0).reshape(b, s, SUBTILE).amax(2, keepdim=True)
    zero = torch.zeros_like(m)
    pad = g * GROUP - s
    g_lo = F.pad(lo, (0, 0, 0, pad), value=inf).reshape(b, g, GROUP, 3).amin(2)
    g_hi = F.pad(hi, (0, 0, 0, pad), value=-inf).reshape(b, g, GROUP, 3).amax(2)
    g_m = F.pad(m, (0, 0, 0, pad)).reshape(b, g, GROUP, 1).amax(2)
    return (torch.cat([lo, m, hi, zero], -1),
            torch.cat([g_lo, g_m, g_hi, torch.zeros_like(g_m)], -1))


def large_k_layout(k: int, smem_limit: int = SMEM_OPTIN_BYTES):
    """(warps a block, buffers in shared memory) of the large-k near walk
    (k > ``REGISTER_MAX_K``): the most warps (4, 2, 1) whose boxes, staged
    candidates (1536 bytes a warp) and 64 buffers of the k - 32 values past
    the registers a warp fit in ``smem_limit`` bytes, the far walk's 4 warps
    of 2 k + ``LK_PENDING`` floats too; else 4 warps with the buffers in
    the scratch."""
    far = 4 * (2 * k + LK_PENDING) * 4
    past = k - REGISTER_MAX_K
    for warps in (4, 2, 1):
        if warps * (3 * SUBTILE * 16 + WARP_QUERIES * past * 4) <= smem_limit and far <= smem_limit:
            return warps, True
    return 4, False


def scratch_words(b: int, c: int, k: int, smem_limit: int = SMEM_OPTIN_BYTES) -> int:
    """float32 words of the kernels' scratch, in this order: the candidates
    as (x, y, z, |c|^2) (B, 32 S, 4), the subtile boxes (B, S, 8), the group
    boxes (B, G, 8); for k <= 32 the deferred queries' buffers (B * 32 S, k)
    and rows (B * 32 S int32); for k > 32 the deferred queries' rows and
    k-th distances (B * 32 S each) and, where ``large_k_layout`` puts the
    buffers in the scratch, the near walk's (64 (k - 32) a warp) and the far
    walk's (``FAR_BLOCKS`` x 4 warps x (2 k + ``LK_PENDING``)); then 16
    words of counters (the deferred count and the 64-bit ``STATS``)."""
    s, cp, g = _sizes(c)
    words = b * (cp * 4 + s * 8 + g * 8) + 16
    if k <= REGISTER_MAX_K:
        return words + b * (cp * k + cp)
    warps, shared = large_k_layout(k, smem_limit)
    words += 2 * b * cp
    if not shared:
        per_block = warps * WARP_QUERIES
        words += (b * -(-cp // per_block) * per_block * (k - REGISTER_MAX_K)
                  + FAR_BLOCKS * 4 * (2 * k + LK_PENDING))
    return words


def scratch_boxes(scratch: torch.Tensor, b: int, c: int):
    """The preparation kernel's (subtiles, groups) boxes inside ``scratch``,
    laid out as ``subtile_boxes`` returns them."""
    s, cp, g = _sizes(c)
    at = b * cp * 4
    sub = scratch[at:at + b * s * 8].view(b, s, 8)
    return sub, scratch[at + b * s * 8:at + b * (s + g) * 8].view(b, g, 8)


def scratch_stats(scratch: torch.Tensor) -> dict:
    """The counts the kernels leave in ``scratch`` (reads the card): pairs
    scanned by the warps' near walk and by the deferred queries' far walk,
    subtiles loaded, subtile tests, deferred queries."""
    counts = scratch[-10:].view(torch.int64).tolist()
    return dict(zip(STATS, counts))


def _launch(xyz, valid, k, skip, scratch, out, smem_limit=SMEM_OPTIN_BYTES, frames=None) -> None:
    """The kernels on checked tensors (preparation, near walk, far walk),
    one launch each for frames ``frames`` = (first, count), all by default;
    ``scratch`` holds ``scratch_words(count, C, k, smem_limit)`` words."""
    c = valid.shape[1]
    f0, n = frames or (0, valid.shape[0])
    warps, shared = large_k_layout(k, smem_limit) if k > REGISTER_MAX_K else (4, True)
    at = f0 * c  # float32 xyz (3 a row), bool valid, float32 out
    err = _cuda.library().sd_exact_knn(
        xyz.data_ptr() + 12 * at, valid.data_ptr() + at, scratch.data_ptr(),
        out.data_ptr() + 4 * at, n, c, k, int(skip), warps, int(shared), _cuda.stream_ptr(xyz))
    _cuda.check(err, "knn_mean_distances_exact")


def max_frames(c: int) -> int:
    """Frames of capacity ``c`` a launch takes: ``MAX_FRAMES``, fewer where
    their padded rows would reach 2^31; raises ValueError, naming the
    limit, where not even one frame's do."""
    cp = _sizes(c)[1]
    if cp > MAX_ROWS:
        raise ValueError(f"a frame of {c} rows pads to {cp}, over the kernels' {MAX_ROWS} rows "
                         "a launch")
    return min(MAX_FRAMES, MAX_ROWS // cp)


@torch.library.custom_op(f"{_cuda.NAMESPACE}::exact_knn", mutates_args=(), device_types="cpu")
def _exact_knn_op(xyz: torch.Tensor, valid: torch.Tensor, k: int, skip: bool) -> torch.Tensor:
    """The dispatcher op; on the CPU, the plain version (its ``valid_span``
    reads the data: the op is opaque to an export)."""
    return knn_mean_distances_exact_plain(xyz, valid, k)


@_exact_knn_op.register_fake
def _(xyz, valid, k, skip):
    return valid.new_empty(valid.shape, dtype=torch.float32)


@_exact_knn_op.register_kernel("cuda")
def _(xyz, valid, k, skip):
    """The kernels, the frames in chunks of at most ``max_frames``, or raise."""
    if k < 1:
        raise ValueError(f"k must be at least 1, got k={k}")
    if xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be (B, C, 3), got {tuple(xyz.shape)}")
    b, c, _ = xyz.shape
    _cuda.require(xyz, "xyz", torch.float32)
    _cuda.require(valid, "valid", torch.bool, (b, c))
    out = torch.empty((b, c), dtype=torch.float32, device=xyz.device)
    if out.numel() == 0:
        return out
    chunk = max_frames(c)
    limit = _cuda.smem_limit(xyz.device)
    scratch = torch.empty(scratch_words(min(b, chunk), c, k, limit), dtype=torch.float32,
                          device=xyz.device)
    keys = ("exact_knn", "exact_knn.large_k") if k > REGISTER_MAX_K else ("exact_knn",)
    for frames in _cuda.launch_chunks(b, chunk, *keys):
        _launch(xyz, valid, k, skip, scratch, out, limit, frames)
    return out


def knn_mean_distances_exact(
    xyz: torch.Tensor, valid: torch.Tensor, k: int, skip: bool = True
) -> torch.Tensor:
    """xyz (B, C, 3) float32, valid (B, C) bool -> (B, C) float32, any C,
    through the op ``sd_torch::exact_knn``. CPU tensors take the plain
    version; CUDA tensors launch the kernels (a preparation kernel, grid
    (G, B); the search, grid (ceil(C / BLOCK_QUERIES), B); the deferred
    queries' kernel; for k > 32 the large-k kernels in place of the last
    two; once per chunk of ``max_frames(C)`` frames, counted in
    ``_cuda.launches``) at any B, or raise. ``skip=False`` scans every
    candidate in row order (validation)."""
    with annotate("sd.k4", xyz.is_cuda):
        return _exact_knn_op(xyz, valid, int(k), bool(skip))
