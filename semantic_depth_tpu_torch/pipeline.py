"""The SemanticDepth frame program in PyTorch (port of ``semantic_depth_tpu/pipeline.py``).

    resize (two float32 matrix products) -> FCN-8s softmax masks
    -> monodepth flip batch -> flip-average postprocess -> disparity scaling
    -> back-projection -> masked road denoise chain (MAD, plane, windowed
       kNN statistical filter, slab-aware compaction, weighted radius filter)
    -> road-width endpoints [-> fence chains + plane intersections (f2f)]
    -> overlay

The geometry tail runs the whole frame batch as a written-out leading
dimension, so each hand-written kernel launches once per batch: the windowed
kNN once, the MAD filter four times (road y, road x, fence y, the fence
pair) and the radius count once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import camera as camera_lib
from .config import PipelineConfig
from .models import FCN8s, Monodepth, flip_average_postprocess
from .ops import neighbors, pcl
from .ops.overlay import segmentation_overlay
from .ops.resize import resize_clip_u8
from .runtime import resolve_device, set_full_fp32


@dataclasses.dataclass
class FrameOutputs:
    """Everything the entry points need, as tensors on the pipeline's device.
    ``process_batch`` gives every field a leading batch dimension;
    ``process_frame`` returns one frame's slice."""

    dist_rw: torch.Tensor
    dist_f2f: torch.Tensor  # nan when approach == 'rw'
    rw_found: torch.Tensor  # bool: the sequence script's line_found guard
    left_pt_rw: torch.Tensor  # (3,)
    right_pt_rw: torch.Tensor  # (3,)
    left_pt_f2f: torch.Tensor  # (3,) nan when approach == 'rw'
    right_pt_f2f: torch.Tensor  # (3,)
    road_plane: torch.Tensor  # (4,) [Cx, Cy, Cz, C]
    fence_left_plane: torch.Tensor  # (4,)
    fence_right_plane: torch.Tensor  # (4,)
    road_mask: torch.Tensor  # (h, w) bool
    fence_mask: torch.Tensor  # (h, w) bool
    disparity: torch.Tensor  # (h, w) f32, already multiplied
    points3d: torch.Tensor  # (h, w, 3) f32
    colors: torch.Tensor  # (h, w, 3) f32 RGB 0..255
    overlay_small: torch.Tensor  # (h, w, 3) f32 0..255, input channel order
    frame_small: torch.Tensor  # (h, w, 3) f32 0..255 resized network input
    road_cloud: pcl.MaskedCloud  # compacted + fully denoised road points
    fence_left_valid: torch.Tensor  # (h*w,) bool over points3d.reshape(-1, 3)
    fence_right_valid: torch.Tensor  # (h*w,) bool

    def frame(self, i: int) -> "FrameOutputs":
        """The i-th frame of a batched result."""
        fields = {}
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if isinstance(val, pcl.MaskedCloud):
                val = pcl.MaskedCloud(val.xyz[i], val.rgb[i], val.valid[i])
            else:
                val = val[i]
            fields[f.name] = val
        return FrameOutputs(**fields)


_REF_H, _REF_W = 256, 512  # the reference networks' working resolution


def _denoise_road(cloud: pcl.MaskedCloud, cfg: PipelineConfig, grid_hw):
    """Road denoise chain (semantic_depth.py:206-245) over (B, H*W) clouds
    back-projected from (H, W) = ``grid_hw`` grids.

    The radius filter's counts stay on the reference's 256x512 density
    scale: compacted (stride-subsampled) candidates carry their stride as
    weight, and a denser grid divides by the pixel ratio."""
    rc = cfg.road
    if rc.stat_mode != "grid":
        raise NotImplementedError(
            "stat_mode='exact' (the exact kNN kernel) is not ported yet"
        )
    cloud = pcl.keep_beyond(cloud, 2, rc.z_keep_beyond)
    cloud = pcl.mad_filter(cloud, rc.mad_y.axis, rc.mad_y.threshold)
    cloud = pcl.mad_filter(cloud, rc.mad_x.axis, rc.mad_x.threshold)
    cloud, road_plane = pcl.plane_inlier_filter(cloud, rc.plane.axis, rc.plane.threshold)
    h, w = grid_hw
    px_scale = (h * w) / float(_REF_H * _REF_W)
    # Overflow compaction keeps the road-width slab at full density (its
    # min/max-x points are the output) and stride-subsamples the rest.
    depth_rw = cfg.depth - cfg.rw_depth_offset
    slab_lo = -(depth_rw + cfg.rw_slab_halfwidth)
    slab_hi = -(depth_rw - cfg.rw_slab_halfwidth)
    lead = cloud.valid.shape[:-1]
    # the window stays (5, 21) at every resolution (JAX pipeline notes)
    new_valid = neighbors.statistical_outlier_filter_grid(
        cloud.xyz.reshape(lead + (h, w, 3)),
        cloud.valid.reshape(lead + (h, w)),
        rc.stat_nb_neighbors,
        rc.stat_std_ratio,
        rc.stat_window,
    )
    cloud = cloud.with_mask(new_valid.reshape(lead + (h * w,)))
    cloud, weights = pcl.compact_slab_aware(
        cloud, rc.neighbor_capacity, 2, slab_lo, slab_hi, px_scale
    )
    cloud = neighbors.radius_outlier_filter(
        cloud, rc.radius_nb_points, rc.radius, weights=weights
    )
    return cloud, road_plane


def _fence_f2f(fence: pcl.MaskedCloud, road_plane: torch.Tensor, cfg: PipelineConfig):
    """Fence denoise chains + plane-plane intersections (semantic_depth.py:273-324)."""
    fc = cfg.fence
    fence = pcl.mad_filter(fence, fc.mad_y.axis, fc.mad_y.threshold)
    fence = pcl.threshold_abs(fence, 2, fc.z_abs_threshold)
    left, right = pcl.split_by_mean(fence, 0)
    if fc.mad_x_left.axis != fc.mad_x_right.axis:
        raise ValueError(
            f"fence mad_x axes must match for the paired filter: "
            f"{fc.mad_x_left.axis} vs {fc.mad_x_right.axis}"
        )
    left, right = pcl.mad_filter_pair(
        left, right, fc.mad_x_left.axis, fc.mad_x_left.threshold, fc.mad_x_right.threshold,
    )
    left, left_plane = pcl.plane_inlier_filter(left, fc.plane_left.axis, fc.plane_left.threshold)
    right, right_plane = pcl.plane_inlier_filter(
        right, fc.plane_right.axis, fc.plane_right.threshold
    )
    left_pt = pcl.planes_intersection_at_depth(road_plane, left_plane, cfg.depth)
    right_pt = pcl.planes_intersection_at_depth(road_plane, right_plane, cfg.depth)
    dist = pcl.distance_3d(left_pt, right_pt)
    return left, right, left_plane, right_plane, left_pt, right_pt, dist


def _road_width(cfg, road_cloud, road_plane, cam):
    """Road-width endpoints under cfg.rw_estimator: 'slab_minmax' (the
    reference, min/max x of the measured slab points) or 'plane_edge'
    (ray-plane intersection of the same slab points)."""
    depth_rw = cfg.depth - cfg.rw_depth_offset
    if cfg.rw_estimator == "plane_edge":
        return pcl.plane_edge_width_cloud(
            road_cloud, road_plane, cam.focal, depth_rw, cfg.rw_slab_halfwidth
        )
    if cfg.rw_estimator != "slab_minmax":
        raise ValueError(f"unknown rw_estimator: {cfg.rw_estimator!r}")
    left, right, found = pcl.road_endpoints(road_cloud, depth_rw, cfg.rw_slab_halfwidth)
    # width along x only (semantic_depth.py:259)
    return left, right, found, (left[..., 0] - right[..., 0]).abs()


def _scaled_camera(cfg: PipelineConfig, focal):
    """Intrinsics at the working resolution: cx and the focal scale with
    width, cy with height (exactly 1.0 at 256x512). Returns (camera, s_w);
    the caller scales the disparity multiplier by s_w."""
    s_w = cfg.input_width / float(_REF_W)
    s_h = cfg.input_height / float(_REF_H)
    if abs(s_w - s_h) > 1e-9:
        raise ValueError(
            f"input {cfg.input_height}x{cfg.input_width} breaks the camera "
            f"preset's 2:1 aspect ({_REF_H}x{_REF_W}): width factor {s_w:g} "
            f"!= height factor {s_h:g}"
        )
    cam = dataclasses.replace(
        cfg.camera,
        focal=focal * s_w,
        cx=cfg.camera.cx * s_w,
        cy=cfg.camera.cy * s_h,
    )
    return cam, s_w


def resolve_frame_scalars(cfg: PipelineConfig, frame_width: int, focal, disparity_mult):
    """Default the per-frame scalars: focal from the config camera; the
    disparity multiplier from the config or the ORIGINAL frame width
    (semantic_depth.py:109,145)."""
    if focal is None:
        focal = cfg.camera.focal
    if disparity_mult is None:
        disparity_mult = (
            cfg.disparity_multiplier
            if cfg.disparity_multiplier is not None
            else float(frame_width)
        )
    return focal, disparity_mult


def _f32(x) -> float:
    """A scalar rounded to float32, as the JAX pipeline's traced scalars are."""
    return float(torch.tensor(float(x), dtype=torch.float32))


class SemanticDepthPipeline:
    """Owns the two networks and runs the frame program.

    Args:
      config: pipeline configuration (presets in ``config``).
      fcn / mono: the networks (``models.FCN8s`` / ``models.Monodepth``);
        moved to ``device`` and switched to inference mode here.
      device: ``None`` (the card; raises without one) or e.g. ``"cpu"``.
    """

    def __init__(self, config: PipelineConfig, fcn: FCN8s, mono: Monodepth, device=None):
        self.config = config
        self.device = resolve_device(device)
        set_full_fp32()
        self.fcn = fcn.to(self.device).eval()
        self.mono = mono.to(self.device).eval()

    # --- the three batch stages ------------------------------------------
    def _batch_segment(self, frames: torch.Tensor):
        """Resize + FCN-8s forward + 0.5-threshold masks for a frame batch.
        Returns (small f32 (B,h,w,3) 0..255, road_masks, fence_masks)."""
        cfg = self.config
        small = resize_clip_u8(frames.float(), (cfg.input_height, cfg.input_width))
        probs = torch.softmax(self.fcn(small), dim=-1)
        thr = cfg.segmenter.threshold
        return small, probs[..., 0] > thr, probs[..., 1] > thr

    def _batch_disparity(self, small: torch.Tensor, disparity_mult: float) -> torch.Tensor:
        """Monodepth forward on the flip batch (semantic_depth.py:667-678);
        ``disparity_mult`` already carries the width factor."""
        b = small.shape[0]
        norm = small.float() / small.new_tensor(255.0)  # a true division on the card too
        if self.config.monodepth.flip_average:
            flip_batch = torch.cat([norm, norm.flip(2)], dim=0)  # (2B, h, w, 3)
            disp_all = self.mono.disp_left(flip_batch)
            pairs = torch.stack([disp_all[:b], disp_all[b:]], dim=1)  # (B, 2, h, w)
            return flip_average_postprocess(pairs) * disparity_mult
        return self.mono.disp_left(norm) * disparity_mult

    def _batch_geometry(self, small, road_masks, fence_masks, disps, cam) -> FrameOutputs:
        """Back-projection -> masked clouds -> denoise -> rw endpoints ->
        (f2f) -> overlay, over the whole batch at once."""
        cfg = self.config
        h, w = cfg.input_height, cfg.input_width
        b = small.shape[0]
        points3d = camera_lib.reproject_disparity(disps, cam)
        colors = small.flip(-1)  # BGR -> RGB (semantic_depth.py:161)

        road = pcl.from_dense(points3d, colors, road_masks)
        road, road_plane = _denoise_road(road, cfg, (h, w))
        left_rw, right_rw, found, dist_rw = _road_width(cfg, road, road_plane, cam)

        if cfg.approach == "both":
            fence = pcl.from_dense(points3d, colors, fence_masks)
            fl, fr, lplane, rplane, left_f2f, right_f2f, dist_f2f = _fence_f2f(
                fence, road_plane, cfg
            )
            fl_valid, fr_valid = fl.valid, fr.valid
        else:
            nan = float("nan")
            dist_f2f = torch.full((b,), nan, device=small.device)
            left_f2f = right_f2f = torch.full((b, 3), nan, device=small.device)
            lplane = rplane = torch.full((b, 4), nan, device=small.device)
            fl_valid = fr_valid = torch.zeros((b, h * w), dtype=torch.bool, device=small.device)

        overlay = segmentation_overlay(
            small, road_masks, fence_masks, cfg.segmenter.road_rgba, cfg.segmenter.fence_rgba
        )
        return FrameOutputs(
            dist_rw=dist_rw, dist_f2f=dist_f2f, rw_found=found,
            left_pt_rw=left_rw, right_pt_rw=right_rw,
            left_pt_f2f=left_f2f, right_pt_f2f=right_f2f,
            road_plane=road_plane, fence_left_plane=lplane, fence_right_plane=rplane,
            road_mask=road_masks, fence_mask=fence_masks, disparity=disps,
            points3d=points3d, colors=colors, overlay_small=overlay,
            frame_small=small, road_cloud=road,
            fence_left_valid=fl_valid, fence_right_valid=fr_valid,
        )

    # --- entry points ------------------------------------------------------
    @torch.inference_mode()
    def process_batch(
        self, frames, focal: Optional[float] = None, disparity_mult: Optional[float] = None
    ) -> FrameOutputs:
        """frames (B, H0, W0, 3), any resolution, 0..255 (uint8 welcome) in
        the caller's channel order -> FrameOutputs with a leading batch axis.
        focal overrides the config camera's; disparity_mult defaults to the
        ORIGINAL frame width (semantic_depth.py:109)."""
        cfg = self.config
        frames = torch.as_tensor(frames).to(self.device)
        focal, disparity_mult = resolve_frame_scalars(cfg, frames.shape[2], focal, disparity_mult)
        cam, s_w = _scaled_camera(cfg, _f32(focal))
        small, road_masks, fence_masks = self._batch_segment(frames)
        disps = self._batch_disparity(small, _f32(_f32(disparity_mult) * s_w))
        return self._batch_geometry(small, road_masks, fence_masks, disps, cam)

    def process_frame(
        self, frame, focal: Optional[float] = None, disparity_mult: Optional[float] = None
    ) -> FrameOutputs:
        """One frame (H0, W0, 3): a batch of one."""
        frame = torch.as_tensor(frame)
        return self.process_batch(frame[None], focal, disparity_mult).frame(0)
