"""The SemanticDepth geometry in plain PyTorch, from the reference program
(pablopalafox/semantic-depth, ``semantic_depth.py`` and ``pcl.py``).

Every function takes one frame or a batch of frames as a leading axis and
keeps a cloud as dense rows with a validity mask. The steps:

* resize: OpenCV's INTER_CUBIC (A = -0.75, half-pixel centres, replicated
  border) as two matrix products, rounded and clipped to 0..255;
* back-projection: X = (x - cx) b / d, Y = (cy - y) b / d, Z = -f b / d;
* the road chain: keep z < -7 m; the MAD cut (0.6745 |x - median| / MAD <
  t) on y (t = 15) and x (t = 2); the least-squares plane y(x, z) and the
  residual cut |r| < 5; the statistical filter on the image grid (the
  mean distance to the 10 nearest valid points of a 5x21 window, self
  included; kept if 0 < d < mean + 0.5 sample std over the frame's
  positive finite means); the slab-aware packing into the cloud capacity;
  the density-weighted radius filter (weights of the points closer than
  0.5 m, itself included, summing to more than 80);
* the road width: the extreme x of the packed points in the 10 cm slab at
  the measuring depth;
* the fence chain: MAD on y (t = 5), |z| < 35 m, the split at the mean x,
  MAD on x (left t = 5, right t = 1), the planes x(y, z) with |r| < 1,
  each intersected with the road plane at the measuring depth;
* the overlay: the road, then the fence colour pasted with alpha a / 255,
  rounded after each paste.

Matrix and inner products go through ``precision`` (``matmul``, ``dot``,
``product_operand``), so that the control computes them in TF32. Inner
products and reductions are written in the order of the program's plain
kernels (three products and two sums, no fused multiply-add); in
``precision.REORDERED`` they run in the libraries' order instead, the
witness of a sound program that sums otherwise.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .precision import FLOAT32, Precision, dot, matmul, product_operand

_A = -0.75
REF_H, REF_W = 256, 512  # the networks' reference resolution (the camera's calibration)


def cubic_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) INTER_CUBIC interpolation matrix of one axis."""
    x = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    base = np.floor(x).astype(np.int64)
    frac = x - base
    mat = np.zeros((dst, src), np.float32)
    for tap in range(-1, 3):
        t = np.abs(frac - tap)
        w = np.where(t <= 1.0, (_A + 2.0) * t ** 3 - (_A + 3.0) * t ** 2 + 1.0,
                     np.where(t < 2.0, _A * t ** 3 - 5.0 * _A * t ** 2 + 8.0 * _A * t - 4.0 * _A,
                              0.0))
        np.add.at(mat, (np.arange(dst), np.clip(base + tap, 0, src - 1)), w.astype(np.float32))
    return mat


def resize_u8(frames: torch.Tensor, out_hw, prec: Precision = FLOAT32) -> torch.Tensor:
    """(B, H, W, 3) 0..255 -> (B, h, w, 3) float32 on the integer grid."""
    b, sh, sw, c = frames.shape
    h, w = out_hw
    x = frames.float()
    if (h, w) != (sh, sw):
        wr = torch.from_numpy(cubic_matrix(sh, h)).to(x.device)
        wc = torch.from_numpy(cubic_matrix(sw, w)).to(x.device)
        x = matmul(wr, x.reshape(b, sh, sw * c), prec)
        x = x.reshape(b, h, sw, c).transpose(2, 3).reshape(b, h * c, sw)
        x = matmul(x, wc.T, prec).reshape(b, h, c, w).transpose(2, 3)
    return torch.clamp(torch.round(x), 0.0, 255.0)


def scaled_camera(camera: Dict[str, float], focal, h: int, w: int):
    """(cx, cy, baseline, focal) at (h, w): cx and the focal scale with the
    width, cy with the height. ``focal`` is float32 as the program takes it."""
    s_w, s_h = w / float(REF_W), h / float(REF_H)
    f = torch.tensor(float(focal), dtype=torch.float32) * s_w
    return camera["cx"] * s_w, camera["cy"] * s_h, camera["baseline"], f


def reproject(disp: torch.Tensor, cam) -> torch.Tensor:
    """(..., H, W) pixel disparities -> (..., H, W, 3) points."""
    cx, cy, baseline, f = cam
    h, w = disp.shape[-2:]
    disp = disp.float()
    xs = torch.arange(w, dtype=torch.float32, device=disp.device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=disp.device)[:, None]
    inv = torch.div(disp.new_tensor(baseline), disp)
    return torch.stack([(xs - cx) * inv, (cy - ys) * inv, (-f.to(disp.device)) * inv], -1)


# --- masked statistics ------------------------------------------------------

def median(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """numpy's median of the valid values of the last axis (the mean of the
    two middle ones for an even count); nan where none is valid."""
    n = valid.sum(-1)
    s = torch.sort(torch.where(valid, values, float("inf")), -1).values
    cap = values.shape[-1] - 1
    lo = s.gather(-1, ((n - 1) // 2).clamp(0, cap)[..., None])[..., 0]
    hi = s.gather(-1, (n // 2).clamp(0, cap)[..., None])[..., 0]
    return torch.where(n > 0, 0.5 * (lo + hi), float("nan"))


def mad_keep(values: torch.Tensor, valid: torch.Tensor, threshold: float) -> torch.Tensor:
    """pcl.remove_noise_by_mad: keep 0.6745 |x - median| / MAD < threshold."""
    med = median(values, valid)
    diff = (values - med[..., None]).abs()
    mad = median(diff, valid)
    penalty = values.new_tensor(0.6745) * diff / mad[..., None]
    return valid & (penalty < threshold)


def fit_plane(xyz: torch.Tensor, valid: torch.Tensor, axis: int, prec: Precision):
    """Least squares of coordinate ``axis`` on the other two (in index
    order), from the centred 2x2 normal equations: (..., 4) = (Cx, Cy, Cz,
    C) with the ``axis`` coefficient -1."""
    ui, vi = [i for i in range(3) if i != axis]
    n = valid.float().sum(-1)
    u, v, b = xyz[..., ui], xyz[..., vi], xyz[..., axis]
    um, vm, bm = (torch.where(valid, t, 0.0).sum(-1) / n for t in (u, v, b))
    uc, vc, bc = (torch.where(valid, t - m[..., None], 0.0) for t, m in ((u, um), (v, vm), (b, bm)))
    suu, svv, suv = dot(uc, uc, prec), dot(vc, vc, prec), dot(uc, vc, prec)
    sub, svb = dot(uc, bc, prec), dot(vc, bc, prec)
    det = suu * svv - suv * suv
    c0 = (svb * (-suv) + sub * svv) / det
    c1 = (svb * suu + sub * (-suv)) / det
    c2 = bm - c0 * um - c1 * vm
    cols = [None] * 4
    cols[ui], cols[vi], cols[3] = c0, c1, c2
    cols[axis] = torch.full_like(c0, -1.0)
    return torch.stack(cols, -1)


def plane_cut(xyz, valid, axis: int, threshold: float, prec: Precision):
    plane = fit_plane(xyz, valid, axis, prec)
    resid = matmul(xyz, plane[..., :3, None], prec)[..., 0] + plane[..., 3:4]
    return valid & (resid.abs() < threshold), plane


# --- the road chain ---------------------------------------------------------

def grid_mean_distances(points: torch.Tensor, valid: torch.Tensor, k: int, window,
                        prec: Precision = FLOAT32) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W): the mean distance from each valid pixel to
    its k nearest valid points of the (wh, ww) window around it, self
    included (each squared distance an inner product of the difference,
    three products and two sums), the k roots added smallest first; +inf for an invalid pixel
    or one with fewer than k valid points in its window. One frame at a
    time (the stencil of one 1024x2048 frame is a few GB)."""
    wh, ww = window
    ph, pw = wh // 2, ww // 2
    out = []
    for f in range(points.shape[0]):
        pv, ok = points[f].float(), valid[f]
        h, w = ok.shape
        pts = torch.where(ok[..., None], pv, 0.0)
        pad = torch.nn.functional.pad(pts, (0, 0, pw, pw, ph, ph))
        pad_ok = torch.nn.functional.pad(ok.to(torch.uint8), (pw, pw, ph, ph)).bool()
        d2 = []
        for dy in range(wh):
            for dx in range(ww):
                e = product_operand(pts - pad[dy:dy + h, dx:dx + w], prec)
                sq = e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2]
                d2.append(torch.where(pad_ok[dy:dy + h, dx:dx + w], sq, float("inf")))
        near = torch.topk(torch.stack(d2, -1), k, -1, largest=False, sorted=True).values
        del d2
        roots = torch.sqrt(near.double()).float()  # correctly rounded float32 roots
        if prec.order == "library":
            acc = roots.sum(-1)
        else:
            acc = torch.zeros((h, w), dtype=torch.float32, device=pv.device)
            for j in range(k):
                acc = acc + roots[..., j]
        out.append(torch.where(ok, acc / acc.new_tensor(float(k)), float("inf")))
    return torch.stack(out)


def statistical_keep(mean_d: torch.Tensor, valid: torch.Tensor, std_ratio: float) -> torch.Tensor:
    finite = valid & torch.isfinite(mean_d)
    pos = finite & (mean_d > 0)
    dims = (-2, -1)
    n = finite.float().sum(dims, keepdim=True)
    mu = torch.where(pos, mean_d, 0.0).sum(dims, keepdim=True) / n
    var = torch.where(pos, (mean_d - mu) ** 2, 0.0).sum(dims, keepdim=True) / (n - 1.0)
    return pos & (mean_d < mu + std_ratio * torch.sqrt(var))


def pack_slab_aware(xyz, valid, capacity: int, lo: float, hi: float, px_scale: float):
    """The points with lo < z < hi all, every s-th other point (s the
    smallest stride that leaves room for them), and of those every r-th
    (r the smallest stride that fits ``capacity``), in row order. Each kept
    point weighs the points it stands for, over the pixel ratio. Returns
    (xyz (B, capacity, 3), valid, weights)."""
    b = xyz.shape[0]
    z = xyz[..., 2]
    in_slab = valid & (z > lo) & (z < hi)
    out = valid & ~in_slab
    n_in = in_slab.sum(-1, keepdim=True)
    n_out = out.sum(-1, keepdim=True)
    room = torch.clamp(capacity - n_in, min=1)
    stride = torch.clamp((n_out + room - 1) // room, min=1)
    rank_out = torch.cumsum(out.long(), -1)
    sel = in_slab | (out & ((rank_out - 1) % stride == 0))
    n_sel = sel.sum(-1, keepdim=True)
    resid = torch.clamp((n_sel + capacity - 1) // capacity, min=1)
    take = sel & ((torch.cumsum(sel.long(), -1) - 1) % resid == 0)
    pxyz = xyz.new_zeros((b, capacity, 3))
    pvalid = valid.new_zeros((b, capacity))
    weights = xyz.new_zeros((b, capacity))
    for f in range(b):
        rows = take[f].nonzero()[:, 0][:capacity]
        m = rows.numel()
        pxyz[f, :m] = xyz[f, rows]
        pvalid[f, :m] = True
        w = torch.where(in_slab[f, rows], 1.0, stride[f].float()) * resid[f].float()
        weights[f, :m] = w / w.new_tensor(px_scale)
    return pxyz, pvalid, weights


def radius_weight_sums(xyz, valid, weights, radius: float, prec: Precision, block: int = 1024):
    """For each valid point, the weights of the valid points with squared
    distance max(|q|^2 + |c|^2 - 2 q.c, 0) below radius^2 (FLANN's strict
    test), each inner product written out as three products and two sums
    in coordinate order; 0 elsewhere."""
    w = torch.where(valid, weights, 0.0)
    p = product_operand(torch.where(valid[..., None], xyz, 0.0), prec)
    x, y, z = p.unbind(-1)
    sq = x * x + y * y + z * z
    out = torch.zeros_like(w)
    r2 = float(radius) ** 2
    for q0 in range(0, xyz.shape[1], block):
        qs = slice(q0, q0 + block)
        if prec.order == "library":
            cross = torch.matmul(p[:, qs], p.transpose(1, 2))
        else:
            cross = (x[:, qs, None] * x[:, None, :] + y[:, qs, None] * y[:, None, :]
                     + z[:, qs, None] * z[:, None, :])
        d2 = torch.clamp_min((sq[:, qs, None] + sq[:, None, :]) - 2.0 * cross, 0.0)
        out[:, qs] = torch.where(d2 < r2, w[:, None, :], 0.0).sum(-1)
    return torch.where(valid, out, 0.0)


def road_chain(points, road_mask, cfg, depth: float, prec: Precision = FLOAT32):
    """The road denoise chain on (B, H, W, 3) points under (B, H, W) masks.
    Returns the packed cloud, its kept mask, the road plane and what the
    kernels of the chain read (for their bounds)."""
    rc = cfg["road"]
    b, h, w = road_mask.shape
    xyz = points.reshape(b, h * w, 3).float()
    valid = road_mask.reshape(b, h * w) & (xyz[..., 2] < -rc["z_keep_beyond"])
    valid = mad_keep(xyz[..., 1], valid, rc["mad_y"])
    valid = mad_keep(xyz[..., 0], valid, rc["mad_x"])
    valid, plane = plane_cut(xyz, valid, 1, rc["plane"], prec)
    knn_valid = valid.reshape(b, h, w)
    mean_d = grid_mean_distances(xyz.reshape(b, h, w, 3), knn_valid, rc["stat_k"],
                                 tuple(rc["stat_window"]), prec)
    valid = statistical_keep(mean_d, knn_valid, rc["stat_std_ratio"]).reshape(b, h * w)
    depth_rw = depth - cfg["rw_depth_offset"]
    hw_slab = cfg["rw_slab_halfwidth"]
    px_scale = (h * w) / float(REF_H * REF_W)
    pxyz, pvalid, weights = pack_slab_aware(xyz, valid, rc["capacity"], -(depth_rw + hw_slab),
                                            -(depth_rw - hw_slab), px_scale)
    counts = radius_weight_sums(pxyz, pvalid, weights, rc["radius"], prec)
    keep = pvalid & (counts > rc["radius_nb_points"])
    return dict(xyz=pxyz, keep=keep, plane=plane, knn_valid=knn_valid,
                packed_valid=pvalid, mad_elements=[b * h * w, b * h * w])


def road_width(xyz, keep, depth: float, cfg):
    """The slab_minmax road width: (left, right, found, dist)."""
    depth_rw = depth - cfg["rw_depth_offset"]
    hw_slab = cfg["rw_slab_halfwidth"]
    z, x = xyz[..., 2], xyz[..., 0]
    slab = keep & (z < -(depth_rw - hw_slab)) & (z > -(depth_rw + hw_slab))
    found = slab.any(-1)
    li = torch.where(slab, x, float("inf")).argmin(-1)
    ri = torch.where(slab, x, float("-inf")).argmax(-1)
    left = xyz.gather(1, li[:, None, None].expand(-1, 1, 3))[:, 0]
    right = xyz.gather(1, ri[:, None, None].expand(-1, 1, 3))[:, 0]
    left = torch.where(found[:, None], left, float("nan"))
    right = torch.where(found[:, None], right, float("nan"))
    return left, right, found, (left[:, 0] - right[:, 0]).abs()


def intersect_at_depth(pa: torch.Tensor, pb: torch.Tensor, depth: float) -> torch.Tensor:
    """The point of planes a and b at z = -depth (the 2x2 solve in x, y)."""
    z = -depth
    b1 = -(pa[..., 2] * z + pa[..., 3])
    b2 = -(pb[..., 2] * z + pb[..., 3])
    det = pa[..., 0] * pb[..., 1] - pa[..., 1] * pb[..., 0]
    x = (b1 * pb[..., 1] - b2 * pa[..., 1]) / det
    y = (pa[..., 0] * b2 - pb[..., 0] * b1) / det
    return torch.stack([x, y, torch.full_like(x, z)], -1)


def fence_chain(points, fence_mask, road_plane, cfg, depth: float, prec: Precision = FLOAT32):
    """Fence planes and the fence-to-fence distance at the measuring depth."""
    fc = cfg["fence"]
    b, h, w = fence_mask.shape
    xyz = points.reshape(b, h * w, 3).float()
    valid = mad_keep(xyz[..., 1], fence_mask.reshape(b, h * w), fc["mad_y"])
    valid = valid & (xyz[..., 2].abs() < fc["z_abs"])
    x = xyz[..., 0]
    mean = torch.where(valid, x, 0.0).sum(-1) / valid.float().sum(-1)
    left = valid & (x < mean[:, None])
    right = valid & (x > mean[:, None])
    left = mad_keep(x, left, fc["mad_x_left"])
    right = mad_keep(x, right, fc["mad_x_right"])
    left, lplane = plane_cut(xyz, left, 0, fc["plane"], prec)
    right, rplane = plane_cut(xyz, right, 0, fc["plane"], prec)
    lp = intersect_at_depth(road_plane, lplane, depth)
    rp = intersect_at_depth(road_plane, rplane, depth)
    d = lp - rp
    return dict(left_plane=lplane, right_plane=rplane, dist=torch.sqrt((d * d).sum(-1)),
                mad_elements=[b * h * w, 2 * b * h * w])


def _paste(img, mask, rgba):
    color = torch.tensor(rgba[:3], dtype=torch.float32, device=img.device)
    alpha = torch.tensor(np.float32(rgba[3]) / np.float32(255.0), device=img.device)
    blended = torch.clamp(torch.round(img * (1.0 - alpha) + color * alpha), 0.0, 255.0)
    return torch.where(mask[..., None], blended, img)


def overlay(small, road_mask, fence_mask, road_rgba, fence_rgba) -> torch.Tensor:
    out = torch.clamp(torch.round(small.float()), 0.0, 255.0)
    return _paste(_paste(out, road_mask, road_rgba), fence_mask, fence_rgba)


def tail(points_or_disp, masks: Tuple[torch.Tensor, torch.Tensor], cam, cfg, depth: float,
         prec: Precision = FLOAT32):
    """The whole geometry tail on given disparities (B, H, W) and (road,
    fence) masks: what the program's tail outputs, and its kernels' inputs."""
    points = reproject(points_or_disp, cam)
    road = road_chain(points, masks[0], cfg, depth, prec)
    left, right, found, dist_rw = road_width(road["xyz"], road["keep"], depth, cfg)
    out = dict(keep=road["keep"], road_plane=road["plane"], dist_rw=dist_rw, rw_found=found,
               knn_valid=road["knn_valid"], packed_xyz=road["xyz"],
               packed_valid=road["packed_valid"], mad_elements=list(road["mad_elements"]))
    if cfg["approach"] == "both":
        fence = fence_chain(points, masks[1], road["plane"], cfg, depth, prec)
        out.update(fence_left_plane=fence["left_plane"], fence_right_plane=fence["right_plane"],
                   dist_f2f=fence["dist"])
        out["mad_elements"] += fence["mad_elements"]
    return out
