"""The SemanticDepth frame program in PyTorch (port of ``semantic_depth_tpu/pipeline.py``).

    resize (two float32 matrix products) -> FCN-8s softmax masks
    -> monodepth flip batch -> flip-average postprocess -> disparity scaling
    -> back-projection -> masked road denoise chain (MAD, plane, windowed
       kNN statistical filter, slab-aware compaction, weighted radius filter;
       under road.stat_mode="exact" the exact kNN filter after the compaction)
    -> road-width endpoints [-> fence chains + plane intersections (f2f)]
    -> overlay

The geometry tail runs the whole frame batch as a written-out leading
dimension, so each hand-written kernel launches once per batch: the kNN
once (the windowed one, or the exact one under ``road.stat_mode="exact"``),
the MAD filter four times (road y, road x, fence y, the fence pair) and the
radius count once. ``process_frame_staged`` runs one frame stage by stage,
for per-stage wall times. The program opens ``runtime.annotate`` spans at
its stages (``sd.call``, ``sd.upload``, ``sd.networks``, ``sd.tail`` and
their children; the list is in ``runtime``), free while tracing is off.
On the card the geometry tail replays a CUDA graph a shape, camera and
config (``_batch_geometry``), and monodepth one a shape and weights
(``_batch_disparity``; ``graphs``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from . import camera as camera_lib
from . import graphs
from .config import PipelineConfig
from .models import FCN8s, Monodepth, flip_average_postprocess
from .ops import neighbors, pcl
from .ops.overlay import segmentation_overlay
from .ops.resize import resize_clip_u8
from .runtime import CALL, annotate, device_constant, resolve_device, set_full_fp32


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

    def replace(self, **changes) -> "FrameOutputs":
        """A copy with ``changes`` (flax's ``struct.dataclass.replace``)."""
        return dataclasses.replace(self, **changes)

    def map(self, fn) -> "FrameOutputs":
        """``fn`` applied to every tensor (or array) field, the road
        cloud's three included; a field left None stays None."""
        fields = {}
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if isinstance(val, pcl.MaskedCloud):
                val = pcl.MaskedCloud(fn(val.xyz), fn(val.rgb), fn(val.valid))
            elif val is not None:
                val = fn(val)
            fields[f.name] = val
        return FrameOutputs(**fields)

    def frame(self, i: int) -> "FrameOutputs":
        """The i-th frame of a batched result (tensors or numpy arrays)."""
        return self.map(lambda v: v[i])

    def leaves(self) -> list:
        """The tensors of every field in field order, the road cloud's three
        in its place (for collectives that move them in one buffer)."""
        out = []
        self.map(out.append)
        return out

    @classmethod
    def from_leaves(cls, leaves) -> "FrameOutputs":
        """Inverse of ``leaves``."""
        it = iter(leaves)
        return cls(**{f.name: (pcl.MaskedCloud(next(it), next(it), next(it))
                               if f.name == "road_cloud" else next(it))
                      for f in dataclasses.fields(cls)})


_REF_H, _REF_W = 256, 512  # the reference networks' working resolution


def _denoise_road(cloud: pcl.MaskedCloud, cfg: PipelineConfig, grid_hw):
    """Road denoise chain (semantic_depth.py:206-245) over (B, H*W) clouds
    back-projected from (H, W) = ``grid_hw`` grids.

    ``cfg.road.stat_mode`` picks the statistical filter: 'grid' windows the
    kNN on the image grid before compaction; any other value runs the exact
    kNN over the compacted cloud, as the JAX pipeline does.

    The radius filter's counts stay on the reference's 256x512 density
    scale: compacted (stride-subsampled) candidates carry their stride as
    weight, and a denser grid divides by the pixel ratio."""
    rc = cfg.road
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
    if rc.stat_mode == "grid":
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
    else:
        cloud, weights = pcl.compact_slab_aware(
            cloud, rc.neighbor_capacity, 2, slab_lo, slab_hi, px_scale
        )
        cloud = neighbors.statistical_outlier_filter(
            cloud, rc.stat_nb_neighbors, rc.stat_std_ratio
        )
        weights = torch.where(cloud.valid, weights, 0.0)
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
    width, cy with height (exactly 1.0 at 256x512). ``focal`` is a float or
    a 0-d float32 tensor (then the camera's focal is one too, scaled in
    float32 as JAX scales its traced focal). Returns (camera, s_w); the
    caller scales the disparity multiplier by s_w."""
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


def _no_fences(b: int, n: int, device):
    """The fence outputs under approach 'rw': (dist_f2f, left_f2f,
    right_f2f, left plane, right plane, left valid, right valid), nan and
    empty, for a batch of ``b`` frames of ``n`` pixels."""
    nan = float("nan")
    pt = torch.full((b, 3), nan, device=device)
    plane = torch.full((b, 4), nan, device=device)
    none = torch.zeros((b, n), dtype=torch.bool, device=device)
    return torch.full((b,), nan, device=device), pt, pt, plane, plane, none, none


def _tail_key(config: PipelineConfig, inputs, cam):
    """The key of the geometry tail's CUDA graph: the config, each input's
    shape, dtype and device, and the camera's fields as floats (a graph
    holds the host scalars it was captured with). None where a camera field
    is a tensor off the CPU: a graph would read it where it lay at capture."""
    intrinsics = [getattr(cam, f.name) for f in dataclasses.fields(cam)]
    if any(isinstance(v, torch.Tensor) and v.device.type != "cpu" for v in intrinsics):
        return None
    return (config, tuple((t.shape, t.dtype, t.device) for t in inputs),
            tuple(float(v) for v in intrinsics))


def _mono_key(config: PipelineConfig, mono: torch.nn.Module, small: torch.Tensor):
    """The key of monodepth's CUDA graph: ``small``'s shape, dtype and
    device, the flip setting, and what pins the weights the graph reads:
    the module itself and its parameters' and buffers' storage, so that a
    module put in its place, or a ``.to()``, takes a new key (weights loaded
    in place are read at the next replay). ``disparity_mult`` is not in it:
    the multiply runs after the replay."""
    weights = tuple(t.data_ptr() for t in (*mono.parameters(), *mono.buffers()))
    return (small.shape, small.dtype, small.device, config.monodepth.flip_average, mono, weights)


def _scalar(x) -> torch.Tensor:
    """A per-frame scalar as the frame program takes it: a 0-d float32 CPU
    tensor, as the JAX pipeline's traced float32 scalars. Elementwise ops
    take a CPU 0-d tensor beside CUDA tensors with no copy to the card."""
    return torch.tensor(float(x), dtype=torch.float32)


class SemanticDepthPipeline:
    """Owns the two networks and runs the frame program.

    Args:
      config: pipeline configuration (presets in ``config``).
      fcn / mono: the networks (``models.FCN8s`` / ``models.Monodepth``);
        moved to ``device`` and switched to inference mode here.
      device: ``None`` (the card; raises without one) or e.g. ``"cpu"``.
    """

    # how the geometry tail's calls ran, over every pipeline: eagerly,
    # captured into a CUDA graph (and replayed once), replayed
    tail_graphs = dict(eager=0, captures=0, replays=0)
    mono_graphs = dict(eager=0, captures=0, replays=0)  # monodepth's, likewise

    def __init__(self, config: PipelineConfig, fcn: FCN8s, mono: Monodepth, device=None):
        self.config = config
        self.device = resolve_device(device)
        set_full_fp32()
        self.fcn = fcn.to(self.device).eval()
        self.mono = mono.to(self.device).eval()
        self._tail_graphs = graphs.Cache()
        self._mono_graphs = graphs.Cache()

    # --- the three batch stages ------------------------------------------
    def _batch_segment(self, frames: torch.Tensor):
        """Resize + FCN-8s forward + 0.5-threshold masks for a frame batch.
        Returns (small f32 (B,h,w,3) 0..255, road_masks, fence_masks)."""
        cfg = self.config
        with annotate("sd.resize"):
            small = resize_clip_u8(frames.float(), (cfg.input_height, cfg.input_width))
        with annotate("sd.fcn"):
            return (small,) + self._segment(small)

    def _segment(self, small: torch.Tensor, rows=None):
        """FCN-8s forward + 0.5-threshold (road, fence) masks (semantic_depth.py:544-556).
        ``rows``: ``small`` holds this rank's rows (``parallel.spatial``)."""
        return self._masks(torch.softmax(self.fcn(small, rows=rows), dim=-1))

    def _masks(self, probs: torch.Tensor):
        thr = self.config.segmenter.threshold
        return probs[..., 0] > thr, probs[..., 1] > thr

    def _batch_disparity(self, small: torch.Tensor, disparity_mult: float,
                         rows=None) -> torch.Tensor:
        """Monodepth on the flip batch (``_mono_body``) times
        ``disparity_mult``, which already carries the width factor. On the
        card the body runs as one CUDA graph a key (``_mono_key``), by the
        tail's rule (``_batch_geometry``); the multiply runs after the
        replay, on the graph's static output, so the result is the caller's
        own tensor. The body runs eagerly where ``small`` is not a plain
        CUDA tensor, under torch.export or torch.compile, and where ``rows``
        is given (``small`` holds this rank's rows, ``parallel.spatial``:
        the halos pass through ``comm``). ``mono_graphs`` counts how each
        call ran."""
        counts = SemanticDepthPipeline.mono_graphs
        with annotate("sd.monodepth", small.is_cuda):
            if rows is not None or not graphs.graphable((small,)):
                counts["eager"] += 1
                return self._mono_body(small, rows) * disparity_mult
            key = _mono_key(self.config, self.mono, small)
            disp = self._mono_graphs.run(key, counts, self._mono_body, (small,), clone=False)
            return disp * disparity_mult

    def _mono_body(self, small: torch.Tensor, rows=None) -> torch.Tensor:
        """Monodepth forward on the flip batch and the flip-average
        postprocess (semantic_depth.py:667-678), or the frame alone with the
        flip off; every step after the network is row-local."""
        b = small.shape[0]
        # a true division on the card too, with no copy from the host
        norm = small.float() / device_constant(255.0, small.device)
        if self.config.monodepth.flip_average:
            flip_batch = torch.cat([norm, norm.flip(2)], dim=0)  # (2B, h, w, 3)
            disp_all = self.mono.disp_left(flip_batch, rows)
            pairs = torch.stack([disp_all[:b], disp_all[b:]], dim=1)  # (B, 2, h, w)
            return flip_average_postprocess(pairs)
        return self.mono.disp_left(norm, rows)

    def _batch_geometry(self, small, road_masks, fence_masks, disps, cam) -> FrameOutputs:
        """The geometry tail (``_tail_body``) over the whole batch. On the
        card it runs as one CUDA graph a key (``_tail_key``): the first
        sight of a key runs the body eagerly, the second captures it and
        replays, every later one replays (``graphs``; at most
        ``graphs.SIZE`` graphs a pipeline). The body runs eagerly wherever
        an input is not a plain CUDA tensor, under torch.export or
        torch.compile, and where a camera field is a tensor on the card.
        ``tail_graphs`` counts how each call ran."""
        counts = SemanticDepthPipeline.tail_graphs
        inputs = (small, road_masks, fence_masks, disps)
        key = _tail_key(self.config, inputs, cam) if graphs.graphable(inputs) else None
        if key is None:
            counts["eager"] += 1
            return self._tail_body(*inputs, cam)
        return self._tail_graphs.run(key, counts, self._tail_body, inputs, cam)

    def _tail_body(self, small, road_masks, fence_masks, disps, cam) -> FrameOutputs:
        """Back-projection -> masked clouds -> denoise -> rw endpoints ->
        (f2f) -> overlay, over the whole batch at once."""
        cfg = self.config
        h, w = cfg.input_height, cfg.input_width
        b = small.shape[0]
        points3d = camera_lib.reproject_disparity(disps, cam)
        colors = small.flip(-1)  # BGR -> RGB (semantic_depth.py:161)

        with annotate("sd.road"):
            road = pcl.from_dense(points3d, colors, road_masks)
            road, road_plane = _denoise_road(road, cfg, (h, w))
            left_rw, right_rw, found, dist_rw = _road_width(cfg, road, road_plane, cam)

        if cfg.approach == "both":
            with annotate("sd.fence"):
                fence = pcl.from_dense(points3d, colors, fence_masks)
                fl, fr, lplane, rplane, left_f2f, right_f2f, dist_f2f = _fence_f2f(
                    fence, road_plane, cfg
                )
            fl_valid, fr_valid = fl.valid, fr.valid
        else:
            dist_f2f, left_f2f, right_f2f, lplane, rplane, fl_valid, fr_valid = _no_fences(
                b, h * w, small.device)

        with annotate("sd.overlay"):
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

    # --- public per-frame stages ---------------------------------------------
    @torch.inference_mode()
    def segment(self, frame_small):
        """FCN-8s forward + 0.5-threshold masks of one resized frame
        (semantic_depth.py:544-556). frame_small (h, w, 3) float32 0..255 ->
        (road (h, w) bool, fence (h, w) bool, probs (h, w, classes))."""
        small = torch.as_tensor(frame_small).to(self.device).float()
        probs = torch.softmax(self.fcn(small[None]), dim=-1)[0]
        return self._masks(probs) + (probs,)

    @torch.inference_mode()
    def disparity(self, frame_small, disparity_mult) -> torch.Tensor:
        """Monodepth flip-batch forward + flip-average postprocess + scaling
        of one resized frame (semantic_depth.py:667-678, 144-145): (h, w, 3)
        -> (h, w) float32. ``disparity_mult`` is applied as given (no width
        factor)."""
        small = torch.as_tensor(frame_small).to(self.device).float()
        return self._batch_disparity(small[None], _scalar(disparity_mult))[0]

    # --- entry points ------------------------------------------------------
    def _process_batch_impl(
        self, frames: torch.Tensor, focal: torch.Tensor, disparity_mult: torch.Tensor
    ) -> FrameOutputs:
        """The frame program on a (B, H0, W0, 3) batch on the pipeline's
        device, with ``focal`` and ``disparity_mult`` 0-d float32 tensors
        (the ORIGINAL-width multiplier; the width factor is applied here).
        ``process_batch`` runs it, and ``export.py`` traces it, so the live
        and the frozen program are one code path."""
        on_card = self.device.type == "cuda"
        cam, s_w = _scaled_camera(self.config, focal)
        with annotate("sd.networks", on_card):
            small, road_masks, fence_masks = self._batch_segment(frames)
            disps = self._batch_disparity(small, disparity_mult * s_w)
        with annotate("sd.tail", on_card):
            return self._batch_geometry(small, road_masks, fence_masks, disps, cam)

    @torch.inference_mode()
    def process_batch(
        self, frames, focal: Optional[float] = None, disparity_mult: Optional[float] = None
    ) -> FrameOutputs:
        """frames (B, H0, W0, 3), any resolution, 0..255 (uint8 welcome) in
        the caller's channel order -> FrameOutputs with a leading batch axis.
        focal overrides the config camera's; disparity_mult defaults to the
        ORIGINAL frame width (semantic_depth.py:109)."""
        on_card = self.device.type == "cuda"
        with annotate(CALL, on_card):
            with annotate("sd.upload", on_card):
                frames = torch.as_tensor(frames).to(self.device)
            focal, disparity_mult = resolve_frame_scalars(
                self.config, frames.shape[2], focal, disparity_mult)
            return self._process_batch_impl(frames, _scalar(focal), _scalar(disparity_mult))

    def process_frame(
        self, frame, focal: Optional[float] = None, disparity_mult: Optional[float] = None
    ) -> FrameOutputs:
        """One frame (H0, W0, 3): a batch of one."""
        frame = torch.as_tensor(frame)
        return self.process_batch(frame[None], focal, disparity_mult).frame(0)

    # --- per-stage profiling mode ---------------------------------------------
    @torch.inference_mode()
    def process_frame_staged(
        self, frame, focal: Optional[float] = None, disparity_mult: Optional[float] = None
    ):
        """One frame (H0, W0, 3) stage by stage, with a device synchronise
        after each stage, for real per-stage wall times in the reference's
        ``_times.txt`` format (semantic_depth.py:100-454). Slower than
        ``process_frame``: use it to profile, not to serve.

        Returns (FrameOutputs, times): seconds under the keys read, semantic,
        disparity, to3D, road, rw, fences, f2f. The fence chain runs its two
        x cuts as two MAD launches (five per frame in all). The first call
        for each frame shape runs every stage twice untimed, so the times are
        execution and not the first use's set-up (cuDNN plans, the kernel
        library's load, the capture of monodepth's CUDA graph on the card)."""
        cfg = self.config
        h, w = cfg.input_height, cfg.input_width
        frame = torch.as_tensor(frame).to(self.device)
        focal, disparity_mult = resolve_frame_scalars(cfg, frame.shape[1], focal, disparity_mult)
        if not hasattr(self, "_stages"):
            self._build_stages()
        stages = self._stages
        warm_key = tuple(frame.shape)
        if getattr(self, "_stages_warm", None) != warm_key:
            self._stages_warm = warm_key  # set first: the warm-up calls recurse
            for _ in range(2):  # a key's second sight captures monodepth's graph
                self.process_frame_staged(frame, focal, disparity_mult)
        cam, s_w = _scaled_camera(cfg, _scalar(focal))
        mult = _scalar(disparity_mult) * s_w
        times = {}

        def timed(key, stage, *args):
            t0 = time.perf_counter()
            out = stages[stage](*args)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            times[key] = time.perf_counter() - t0
            return out

        small = timed("read", "resize", frame[None])  # the read + resize slot
        road_mask, fence_mask = timed("semantic", "segment", small)
        disparity = timed("disparity", "disparity", small, mult)
        points3d = timed("to3D", "to3d", disparity, cam)
        road_cloud, road_plane = timed("road", "road", points3d, small, road_mask)
        left_rw, right_rw, found, dist_rw = timed("rw", "rw", road_cloud, road_plane, cam)
        if cfg.approach == "both":
            fl_valid, fr_valid, lplane, rplane = timed(
                "fences", "fences", points3d, small, fence_mask)
            left_f2f, right_f2f, dist_f2f = timed("f2f", "f2f", road_plane, lplane, rplane)
        else:
            times["fences"] = times["f2f"] = 0.0
            dist_f2f, left_f2f, right_f2f, lplane, rplane, fl_valid, fr_valid = _no_fences(
                1, h * w, self.device)
        out = FrameOutputs(
            dist_rw=dist_rw, dist_f2f=dist_f2f, rw_found=found,
            left_pt_rw=left_rw, right_pt_rw=right_rw,
            left_pt_f2f=left_f2f, right_pt_f2f=right_f2f,
            road_plane=road_plane, fence_left_plane=lplane, fence_right_plane=rplane,
            road_mask=road_mask, fence_mask=fence_mask, disparity=disparity,
            points3d=points3d, colors=small.flip(-1),
            overlay_small=stages["overlay"](small, road_mask, fence_mask),
            frame_small=small, road_cloud=road_cloud,
            fence_left_valid=fl_valid, fence_right_valid=fr_valid,
        )
        return out.frame(0), times

    def _build_stages(self):
        """The stage functions of ``process_frame_staged``, each over a batch
        of one frame."""
        cfg = self.config
        h, w = cfg.input_height, cfg.input_width

        def road_stage(points3d, small, road_mask):
            road = pcl.from_dense(points3d, small.flip(-1), road_mask)
            return _denoise_road(road, cfg, (h, w))

        def fences_stage(points3d, small, fence_mask):
            fc = cfg.fence
            fence = pcl.from_dense(points3d, small.flip(-1), fence_mask)
            fence = pcl.mad_filter(fence, fc.mad_y.axis, fc.mad_y.threshold)
            fence = pcl.threshold_abs(fence, 2, fc.z_abs_threshold)
            left, right = pcl.split_by_mean(fence, 0)
            left = pcl.mad_filter(left, fc.mad_x_left.axis, fc.mad_x_left.threshold)
            left, lplane = pcl.plane_inlier_filter(
                left, fc.plane_left.axis, fc.plane_left.threshold)
            right = pcl.mad_filter(right, fc.mad_x_right.axis, fc.mad_x_right.threshold)
            right, rplane = pcl.plane_inlier_filter(
                right, fc.plane_right.axis, fc.plane_right.threshold)
            return left.valid, right.valid, lplane, rplane

        def f2f_stage(road_plane, lplane, rplane):
            lp = pcl.planes_intersection_at_depth(road_plane, lplane, cfg.depth)
            rp = pcl.planes_intersection_at_depth(road_plane, rplane, cfg.depth)
            return lp, rp, pcl.distance_3d(lp, rp)

        self._stages = {
            "resize": lambda frames: resize_clip_u8(frames.float(), (h, w)),
            "segment": self._segment,
            "disparity": self._batch_disparity,
            "to3d": camera_lib.reproject_disparity,
            "road": road_stage,
            "rw": lambda cloud, plane, cam: _road_width(cfg, cloud, plane, cam),
            "fences": fences_stage,
            "f2f": f2f_stage,
            "overlay": lambda small, rm, fm: segmentation_overlay(
                small, rm, fm, cfg.segmenter.road_rgba, cfg.segmenter.fence_rgba),
        }
