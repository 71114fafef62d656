"""Masked fixed-capacity point-cloud geometry (port of ``semantic_depth_tpu/ops/pcl.py``).

A cloud is a fixed-capacity masked array: every filter only flips bits in
the validity mask, and reductions are masked reductions. Every function
takes any number of leading batch dimensions (``xyz`` (..., N, 3), ``valid``
(..., N)), so the pipeline's geometry tail runs a whole frame batch per call
and each kernel launches once per batch.

Reference-semantics notes (kept deliberately, see the JAX module):

* ``keep_beyond`` reproduces pcl.remove_from_to (pcl.py:30-43), whose
  ``from_meter`` argument is ignored upstream: "keep coord < -to_meter".
* The MAD penalty is ``0.6745 * |x - median| / MAD`` (pcl.py:63); a nan or
  inf penalty drops the point. The MAD filters run through the hand-written
  kernel of ``ops/mad.py`` on the card.
* Plane fits solve the unweighted least squares of ``scipy.linalg.lstsq`` as
  a centered 2x2 normal-equation solve in float32.
* Ties in min/max selections go to the first index, like ``jnp.argmin``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..runtime import device_constant
from . import mad as mad_ops


@dataclasses.dataclass
class MaskedCloud:
    """``xyz``/``rgb`` rows beyond ``valid`` are inert. ``rgb`` may carry any
    per-point payload (colors here)."""

    xyz: torch.Tensor  # (..., N, 3) float32
    rgb: torch.Tensor  # (..., N, 3) float32
    valid: torch.Tensor  # (..., N) bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return self.valid.sum(-1, dtype=torch.int32)

    def replace(self, **changes) -> "MaskedCloud":
        """A copy with ``changes`` (flax's ``struct.dataclass.replace``)."""
        return dataclasses.replace(self, **changes)

    def with_mask(self, new_valid: torch.Tensor) -> "MaskedCloud":
        return self.replace(valid=new_valid)


def from_dense(points: torch.Tensor, colors: torch.Tensor, mask: torch.Tensor) -> MaskedCloud:
    """Masked cloud of dense (..., H, W, 3) points under an (..., H, W) mask,
    without any gather: the masked form of ``points3D[road_mask]``."""
    lead = points.shape[:-3]
    n = points.shape[-3] * points.shape[-2]
    return MaskedCloud(
        xyz=points.reshape(lead + (n, 3)).float(),
        rgb=colors.reshape(lead + (n, 3)).float(),
        valid=mask.reshape(lead + (n,)).bool(),
    )


def valid_span(valid: torch.Tensor) -> int:
    """One past the last row that is valid in any frame of ``valid``
    (..., N): every row beyond it is invalid in every frame. Compacted
    clouds keep their valid rows in front, so the plain O(N^2) neighbour
    versions work on this span only."""
    rows = valid.reshape(-1, valid.shape[-1]).any(0).nonzero()
    return int(rows[-1]) + 1 if rows.numel() else 0


# ---------------------------------------------------------------------------
# Masked reductions (over the last axis)
# ---------------------------------------------------------------------------


def masked_sum(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, values, 0.0).sum(-1)


def masked_mean(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return masked_sum(values, valid) / valid.float().sum(-1)


def masked_min(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, values, float("inf")).amin(-1)


def masked_max(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, values, float("-inf")).amax(-1)


def masked_median(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """numpy-median semantics over the valid subset of the last axis: the
    mean of the two middle order statistics for an even count, nan when
    empty. Sort-based (``torch.median`` takes the LOWER middle value)."""
    n = valid.sum(-1, dtype=torch.int64)
    cap = values.shape[-1]
    sorted_vals = torch.sort(torch.where(valid, values, float("inf")), dim=-1).values
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, cap - 1)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, cap - 1)
    med = 0.5 * (
        sorted_vals.gather(-1, lo[..., None])[..., 0]
        + sorted_vals.gather(-1, hi[..., None])[..., 0]
    )
    return torch.where(n > 0, med, float("nan"))


_U32 = 0xFFFFFFFF
_SIGN = 0x80000000


def _f32_to_ordered(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32) whose integer order is the float order
    (the IEEE-754 total-order map of the JAX module, in int64 because torch
    has little uint32 arithmetic)."""
    bits = x.float().contiguous().view(torch.int32).long() & _U32
    return torch.where(bits >= _SIGN, ~bits & _U32, bits | _SIGN)


def _ordered_to_f32(u: torch.Tensor) -> torch.Tensor:
    bits = torch.where(u < _SIGN, ~u & _U32, u & 0x7FFFFFFF)
    return torch.where(bits >= _SIGN, bits - (1 << 32), bits).int().view(torch.float32)


def masked_kth_smallest(values: torch.Tensor, valid: torch.Tensor, k) -> torch.Tensor:
    """Exact k-th smallest (0-based) valid element of the last axis, by the
    JAX function's 32-step binary search over the ordered bit space (one
    masked count a step). ``k`` is an int or a tensor over the leading
    dimensions; nan when fewer than k + 1 points are valid."""
    u = _f32_to_ordered(values)
    lead = values.shape[:-1]
    lo = torch.zeros(lead, dtype=torch.int64, device=values.device)
    hi = torch.full(lead, _U32, dtype=torch.int64, device=values.device)
    k = torch.as_tensor(k, device=values.device)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        count = ((u <= mid[..., None]) & valid).sum(-1)
        take_left = count >= k + 1
        lo, hi = torch.where(take_left, lo, mid + 1), torch.where(take_left, mid, hi)
    return _ordered_to_f32(lo)


# ---------------------------------------------------------------------------
# Filters (mask-only updates; mirror pcl.py ops)
# ---------------------------------------------------------------------------


def keep_beyond(cloud: MaskedCloud, axis: int, to_meter: float) -> MaskedCloud:
    """pcl.remove_from_to (pcl.py:30-43): keep points with coord < -to_meter."""
    return cloud.with_mask(cloud.valid & (cloud.xyz[..., axis] < -to_meter))


def threshold_abs(cloud: MaskedCloud, axis: int, threshold: float) -> MaskedCloud:
    """pcl.threshold_complete (pcl.py:240-250): keep |coord| < threshold."""
    return cloud.with_mask(cloud.valid & (cloud.xyz[..., axis].abs() < threshold))


def _mad_rows(values, valid, thresholds):
    """(..., N) planes -> one ``mad_keep_mask`` call over all rows;
    ``thresholds`` is a float or a pair for the two halves of the rows, and
    goes to the kernel by value (no copy to the card)."""
    n = values.shape[-1]
    keep = mad_ops.mad_keep_mask(
        values.reshape(-1, n).contiguous(), valid.reshape(-1, n).contiguous(), thresholds
    )
    return keep.reshape(valid.shape)


def mad_filter(cloud: MaskedCloud, axis: int, threshold: float) -> MaskedCloud:
    """pcl.remove_noise_by_mad (pcl.py:46-81): keep
    0.6745 * |x - median| / MAD < threshold. All leading (frame) rows go to
    the MAD kernel in one launch."""
    return cloud.with_mask(_mad_rows(cloud.xyz[..., axis], cloud.valid, float(threshold)))


def mad_filter_pair(
    a: MaskedCloud, b: MaskedCloud, axis: int, threshold_a: float, threshold_b: float
) -> Tuple[MaskedCloud, MaskedCloud]:
    """Two independent MAD filters (the left/right fence split,
    semantic_depth.py:293-305) as ONE launch over the stacked rows: ``a``'s
    rows take ``threshold_a``, ``b``'s ``threshold_b``. Same results as two
    ``mad_filter`` calls."""
    vals = torch.stack([a.xyz[..., axis], b.xyz[..., axis]])
    valids = torch.stack([a.valid, b.valid])
    keep = _mad_rows(vals, valids, (float(threshold_a), float(threshold_b)))
    return a.with_mask(keep[0]), b.with_mask(keep[1])


def split_by_mean(cloud: MaskedCloud, axis: int = 0) -> Tuple[MaskedCloud, MaskedCloud]:
    """pcl.extract_pcls (pcl.py:253-268): split at the mean coordinate.
    Points exactly at the mean fall in neither half (strict < and >)."""
    x = cloud.xyz[..., axis]
    mean = masked_mean(x, cloud.valid)[..., None]
    return (
        cloud.with_mask(cloud.valid & (x < mean)),
        cloud.with_mask(cloud.valid & (x > mean)),
    )


# ---------------------------------------------------------------------------
# Plane fitting (pcl.remove_noise_by_fitting_plane, pcl.py:84-209)
# ---------------------------------------------------------------------------

# For a plane perpendicular to ``axis`` the reference regresses coordinate
# ``axis`` (b) on the remaining two coordinates (u, v) in index order.
_PLANE_UV = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


def fit_plane(cloud: MaskedCloud, axis: int) -> torch.Tensor:
    """Least-squares plane (..., 4) = (Cx, Cy, Cz, C) with
    Cx*x + Cy*y + Cz*z + C = 0 and the coefficient of ``axis`` = -1
    (pcl.py:135,168,201), from centered 2x2 normal equations."""
    ui, vi = _PLANE_UV[axis]
    valid = cloud.valid
    u = cloud.xyz[..., ui]
    v = cloud.xyz[..., vi]
    b = cloud.xyz[..., axis]
    n = valid.float().sum(-1)
    um = masked_sum(u, valid) / n
    vm = masked_sum(v, valid) / n
    bm = masked_sum(b, valid) / n
    uc = torch.where(valid, u - um[..., None], 0.0)
    vc = torch.where(valid, v - vm[..., None], 0.0)
    bc = torch.where(valid, b - bm[..., None], 0.0)
    suu = (uc * uc).sum(-1)
    svv = (vc * vc).sum(-1)
    suv = (uc * vc).sum(-1)
    sub = (uc * bc).sum(-1)
    svb = (vc * bc).sum(-1)
    det = suu * svv - suv * suv
    c0 = (svb * (-suv) + sub * svv) / det
    c1 = (svb * suu + sub * (-suv)) / det
    c2 = bm - c0 * um - c1 * vm
    cols = [None] * 4
    cols[ui], cols[vi], cols[3] = c0, c1, c2
    cols[axis] = torch.full_like(c0, -1.0)
    return torch.stack(cols, dim=-1)


def _dot3(xyz: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) . (..., 3) -> (..., N)."""
    return torch.matmul(xyz, coeffs[..., :3, None])[..., 0]


def plane_inlier_filter(
    cloud: MaskedCloud, axis: int, threshold: float
) -> Tuple[MaskedCloud, torch.Tensor]:
    """Fit a plane, keep points with |residual| < threshold (pcl.py:130-131).
    Returns (filtered cloud, coeffs)."""
    coeffs = fit_plane(cloud, axis)
    resid = _dot3(cloud.xyz, coeffs) + coeffs[..., 3:4]
    return cloud.with_mask(cloud.valid & (resid.abs() < threshold)), coeffs


def planes_intersection_at_depth(
    coeffs_a: torch.Tensor, coeffs_b: torch.Tensor, depth: float
) -> torch.Tensor:
    """pcl.planes_intersection_at_certain_depth (pcl.py:212-237): intersect
    two planes at z = -depth by the 2x2 solve in (x, y). Returns (..., 3)."""
    z = -depth
    a11, a12 = coeffs_a[..., 0], coeffs_a[..., 1]
    a21, a22 = coeffs_b[..., 0], coeffs_b[..., 1]
    b1 = -(coeffs_a[..., 2] * z + coeffs_a[..., 3])
    b2 = -(coeffs_b[..., 2] * z + coeffs_b[..., 3])
    det = a11 * a22 - a12 * a21
    x = (b1 * a22 - b2 * a12) / det
    y = (a11 * b2 - a21 * b1) / det
    return torch.stack([x, y, torch.full_like(x, z)], dim=-1)


# ---------------------------------------------------------------------------
# Road width (pcl.get_end_points_of_road, pcl.py:271-313)
# ---------------------------------------------------------------------------


def _take_rows(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """xyz (..., N, 3), idx (...) -> (..., 3)."""
    return xyz.gather(-2, idx[..., None, None].expand(idx.shape + (1, 3)))[..., 0, :]


def road_endpoints(
    cloud: MaskedCloud, depth, halfwidth: float = 0.05
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Points with min/max x inside the z-slab (-(depth+hw), -(depth-hw)),
    plus ``found`` (the sequence script's ``line_found`` guard, seq:232-243).
    Returns (left (..., 3), right (..., 3), found (...)); nan when not found."""
    z = cloud.xyz[..., 2]
    slab = cloud.valid & (z < -(depth - halfwidth)) & (z > -(depth + halfwidth))
    found = slab.any(-1)
    x = cloud.xyz[..., 0]
    left_idx = torch.where(slab, x, float("inf")).argmin(-1)
    right_idx = torch.where(slab, x, float("-inf")).argmax(-1)
    f = found[..., None]
    left_pt = torch.where(f, _take_rows(cloud.xyz, left_idx), float("nan"))
    right_pt = torch.where(f, _take_rows(cloud.xyz, right_idx), float("nan"))
    return left_pt, right_pt, found


def distance_3d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """pcl.compute_distance_in_3D (pcl.py:316-318)."""
    d = a - b
    return torch.sqrt((d * d).sum(-1))


def _wlsq(x_e: torch.Tensor, z_e: torch.Tensor, weight: torch.Tensor):
    """Weighted least squares x = alpha + beta * z over the last axis; the
    weighted mean where the rows span less than one distinct z."""
    sw = weight.sum(-1)
    sz = (weight * z_e).sum(-1)
    sx = (weight * x_e).sum(-1)
    szz = (weight * z_e * z_e).sum(-1)
    szx = (weight * z_e * x_e).sum(-1)
    det = sw * szz - sz * sz
    beta = torch.where(det.abs() > 1e-6, (sw * szx - sz * sx) / det, 0.0)
    alpha = (sx - beta * sz) / torch.clamp(sw, min=1.0)
    return alpha, beta


def _edge_fit_at(x_e, wz_e, weight, z_eval):
    """Two-pass robust line fit of the JAX function's ``fit_at``: least
    squares, drop rows further than max(4.4478 MAD, 0.05 m) from the median
    residual, refit when two or more rows survive."""
    x_e = torch.where(weight > 0, x_e, 0.0)
    z_e = torch.where(weight > 0, -wz_e, 0.0)
    a1, b1 = _wlsq(x_e, z_e, weight)
    r = x_e - (a1[..., None] + b1[..., None] * z_e)
    ok = (weight > 0) & ~r.isnan()
    med = masked_median(r, ok)
    dev = (r - med[..., None]).abs()
    gate = torch.maximum(4.4478 * masked_median(dev, ok & ~dev.isnan()), dev.new_tensor(0.05))
    w2 = weight * (dev <= gate[..., None])
    wf = torch.where((w2.sum(-1) >= 2)[..., None], w2, weight)
    a2, b2 = _wlsq(x_e, z_e, wf)
    return a2 + b2 * z_eval


def plane_edge_width(
    road_mask: torch.Tensor,
    road_plane: torch.Tensor,
    cx, cy, focal,
    depth,
    halfwidth: float = 0.5,
    meas_range: Optional[torch.Tensor] = None,
    range_tol: float = 0.25,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Road width from the fitted plane and the mask's edges (the JAX
    function's grid estimator): each pixel ray meets the road plane
    (..., 4) = (a, -1, c, d0), each image row's outermost road pixel widens
    half a pixel footprint outward, and each side line-fits x(z) over the
    rows whose edge lies within ``halfwidth`` of ``depth``, evaluated at
    z = -depth. ``meas_range`` (..., H, W), when given, drops pixels whose
    measured range is further than ``range_tol`` from the plane's.

    road_mask (..., H, W). Returns (left (..., 3), right (..., 3), found,
    width); nan when either side has no row in the slab."""
    h, w = road_mask.shape[-2:]
    dev = road_plane.device
    a = road_plane[..., 0, None, None]
    c = road_plane[..., 2, None, None]
    d0 = road_plane[..., 3, None, None]
    f = torch.as_tensor(focal, dtype=torch.float32, device=dev)
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    v = cy - torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    denom = v - a * u + c * f
    wz = d0 * f / denom
    xhat = u * wz / f
    valid_px = road_mask & torch.isfinite(wz) & (wz > 0.0)
    if meas_range is not None:
        valid_px = valid_px & torch.isfinite(meas_range) & ((meas_range - wz).abs() < range_tol)

    li = torch.where(valid_px, xhat, float("inf")).argmin(-1, keepdim=True)
    ri = torch.where(valid_px, xhat, float("-inf")).argmax(-1, keepdim=True)
    row_any = valid_px.any(-1)
    wz_l, wz_r = wz.gather(-1, li)[..., 0], wz.gather(-1, ri)[..., 0]
    x_l = xhat.gather(-1, li)[..., 0] - 0.5 * wz_l / f
    x_r = xhat.gather(-1, ri)[..., 0] + 0.5 * wz_r / f

    def in_slab(z):
        return (z > depth - halfwidth) & (z < depth + halfwidth)

    wgt_l = (row_any & in_slab(wz_l)).float()
    wgt_r = (row_any & in_slab(wz_r)).float()
    z_eval = -torch.tensor(float(depth), dtype=torch.float32, device=dev)
    xl = _edge_fit_at(x_l, wz_l, wgt_l, z_eval)
    xr = _edge_fit_at(x_r, wz_r, wgt_r, z_eval)
    found = (wgt_l.sum(-1) >= 1) & (wgt_r.sum(-1) >= 1)
    width = torch.where(found, xr - xl, float("nan"))
    a, c, d0 = a[..., 0, 0], c[..., 0, 0], d0[..., 0, 0]

    def point(x):
        pt = torch.stack([x, a * x + c * z_eval + d0, z_eval.expand_as(x)], -1)
        return torch.where(found[..., None], pt, float("nan"))

    return point(xl), point(xr), found, width


def plane_edge_width_cloud(
    cloud: MaskedCloud,
    road_plane: torch.Tensor,
    focal,
    depth,
    halfwidth: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plane-ray road width over a denoised cloud's z-slab: each slab point is
    replaced by its ray's intersection with the fitted road plane, and the
    extremes widen by half a pixel footprint (z/f) per side. Returns (left,
    right, found, width); nan when the slab is empty."""
    p = cloud.xyz
    n_dot = _dot3(p, road_plane)
    t = -road_plane[..., 3:4] / n_dot
    q = t[..., None] * p
    z_meas = p[..., 2]
    sel = (
        cloud.valid
        & torch.isfinite(t)
        & (t > 0.0)
        & (z_meas < -(depth - halfwidth))
        & (z_meas > -(depth + halfwidth))
    )
    found = sel.any(-1)
    qx = q[..., 0]
    left_q = _take_rows(q, torch.where(sel, qx, float("inf")).argmin(-1))
    right_q = _take_rows(q, torch.where(sel, qx, float("-inf")).argmax(-1))
    # a tensor divisor (a true division on the card too), filled on the
    # card: a copy of a host focal would drain the queue
    f = q.new_empty((), dtype=torch.float32).fill_(focal)
    fp_l = -left_q[..., 2] / f
    fp_r = -right_q[..., 2] / f
    left_pt = torch.cat([left_q[..., :1] + (-0.5 * fp_l)[..., None], left_q[..., 1:]], -1)
    right_pt = torch.cat([right_q[..., :1] + (0.5 * fp_r)[..., None], right_q[..., 1:]], -1)
    fnd = found[..., None]
    left_pt = torch.where(fnd, left_pt, float("nan"))
    right_pt = torch.where(fnd, right_pt, float("nan"))
    width = torch.where(found, right_pt[..., 0] - left_pt[..., 0], float("nan"))
    return left_pt, right_pt, found, width


# ---------------------------------------------------------------------------
# Compaction: shrink capacity before the O(N^2) radius kernel
# ---------------------------------------------------------------------------


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def compact_slab_aware(
    cloud: MaskedCloud, capacity: int, axis: int, lo, hi, px_scale: float = 1.0
) -> Tuple[MaskedCloud, torch.Tensor]:
    """Keep the (lo, hi) slab on ``axis`` at full density, stride-subsample
    the rest, pack into ``capacity`` slots (row order kept), and return
    per-survivor density weights: the weighted survivor count equals the
    original valid count divided by ``px_scale``. When the slab alone
    overflows, a residual stride applies to everything and is folded into
    the weights. Row-for-row equal to the JAX function."""
    x = cloud.xyz[..., axis]
    in_slab = cloud.valid & (x > lo) & (x < hi)
    out = cloud.valid & ~in_slab
    csum_in = torch.cumsum(in_slab.int(), -1, dtype=torch.int32)
    csum_out = torch.cumsum(out.int(), -1, dtype=torch.int32)
    n_in, n_out = csum_in[..., -1:], csum_out[..., -1:]
    room = torch.clamp(capacity - n_in, min=1)
    stride_out = torch.clamp(_floordiv(n_out + room - 1, room), min=1)
    # kept out-of-slab rows: every stride_out-th by out-rank; their running
    # count at any row is ceil(csum_out / stride_out)
    kept_out_cnt = _floordiv(csum_out + stride_out - 1, stride_out)
    n_sel = n_in + kept_out_cnt[..., -1:]
    resid_i = torch.clamp(_floordiv(n_sel + capacity - 1, capacity), min=1)
    # output slot j holds the selected row of rank j * resid_i
    csum_sel = (csum_in + kept_out_cnt).contiguous()
    slots = torch.arange(capacity, dtype=torch.int32, device=x.device)
    targets = (slots * resid_i + 1).contiguous()
    src = _ranked_rows(csum_sel, targets)
    kept_n = _floordiv(n_sel + resid_i - 1, resid_i)
    idx = src[..., None].expand(src.shape + (3,))
    packed = MaskedCloud(
        xyz=cloud.xyz.gather(-2, idx),
        rgb=cloud.rgb.gather(-2, idx),
        valid=slots < kept_n,
    )
    xp = packed.xyz[..., axis]
    in_slab_p = packed.valid & (xp > lo) & (xp < hi)
    w = torch.where(in_slab_p, 1.0, stride_out.float()) * resid_i.float()
    w = w / device_constant(px_scale, w.device)  # a true division on the card too
    return packed, torch.where(packed.valid, w, 0.0)


def _ranked_rows(csum: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """src[j] = smallest row r with csum[r] >= targets[j] for a nondecreasing
    ``csum`` (the row of the targets[j]-th kept point), clamped in bounds:
    callers mask rows past the last kept point invalid."""
    src = torch.searchsorted(csum, targets, side="left")
    return torch.clamp(src, max=csum.shape[-1] - 1)


def select_slab_priority(
    cloud: MaskedCloud, capacity: int, axis: int, lo, hi
) -> Tuple[MaskedCloud, torch.Tensor]:
    """Reduce the mask to about ``capacity`` points: every point with coord
    in (lo, hi) (the road-width slab) and an even stride-subsample of the
    rest. Returns (cloud, out_stride (...)); out_stride 1 keeps everything."""
    x = cloud.xyz[..., axis]
    in_slab = cloud.valid & (x > lo) & (x < hi)
    out = cloud.valid & ~in_slab
    n_in = in_slab.sum(-1, keepdim=True, dtype=torch.int32)
    out_idx = torch.cumsum(out.int(), -1, dtype=torch.int32) - 1
    n_out = out_idx[..., -1:] + 1
    room = torch.clamp(capacity - n_in, min=1)
    stride_out = torch.clamp(_floordiv(n_out + room - 1, room), min=1)
    sel = in_slab | (out & (out_idx % stride_out == 0))
    return cloud.with_mask(sel), stride_out[..., 0]


def compact_stride(cloud: MaskedCloud, capacity: int) -> torch.Tensor:
    """The stride ``compact`` subsamples with: 1 when the valid count fits
    ``capacity``, else ceil(n / capacity)."""
    return torch.clamp(_floordiv(cloud.count() + capacity - 1, capacity), min=1)


def compact(cloud: MaskedCloud, capacity: int) -> MaskedCloud:
    """Pack the valid points into the first ``capacity`` slots in row order;
    past ``capacity`` valid points keep every ``compact_stride``-th one."""
    csum = torch.cumsum(cloud.valid.int(), -1, dtype=torch.int32)
    n = csum[..., -1:]
    stride = torch.clamp(_floordiv(n + capacity - 1, capacity), min=1)
    kept = _floordiv(n + stride - 1, stride)
    slots = torch.arange(capacity, dtype=torch.int32, device=csum.device)
    src = _ranked_rows(csum.contiguous(), (slots * stride + 1).contiguous())
    idx = src[..., None].expand(src.shape + (3,))
    return MaskedCloud(xyz=cloud.xyz.gather(-2, idx), rgb=cloud.rgb.gather(-2, idx),
                       valid=slots < kept)
