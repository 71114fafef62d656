"""Typed configuration tree for the SemanticDepth pipeline (PyTorch port).

A standalone copy of ``semantic_depth_tpu/config.py``: the port imports
nothing of the JAX package, and the tests pin every preset equal to the JAX
one field by field.

The reference scatters its configuration over argparse flags and inline magic
constants (semantic_depth.py:706-767, 592-607, 206-219; sequence script
seq:105, seq:500-503). Here every constant lives in one frozen dataclass tree
with per-entry-point presets that preserve the reference defaults bit-for-bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics used to build the reprojection Q-matrix.

    Reference: DepthFrame.__init__ (semantic_depth.py:592-607) holds two
    presets — Cityscapes and the Munich/iPhone test set — plus a sequence
    variant with b=1.0 (semantic_depth_cityscapes_sequence.py:500-503).
    """

    cx: float
    cy: float
    baseline: float
    focal: float

    def with_focal(self, f: float) -> "CameraConfig":
        return dataclasses.replace(self, focal=f)


# Cityscapes intrinsics (semantic_depth.py:592-599).
CAMERA_CITYSCAPES = CameraConfig(cx=1048.64 / 4, cy=519.277 / 4, baseline=0.6, focal=500.0)
# Munich / iPhone test-set intrinsics (semantic_depth.py:601-607).
CAMERA_MUNICH = CameraConfig(cx=314.05519001, cy=124.09658151, baseline=1.0, focal=380.0)
# Sequence-script variant: same optical center as Cityscapes but b=1.0, f=500
# (semantic_depth_cityscapes_sequence.py:500-503).
CAMERA_CITYSCAPES_SEQUENCE = CameraConfig(
    cx=1048.64 / 4, cy=519.277 / 4, baseline=1.0, focal=500.0
)


@dataclasses.dataclass(frozen=True)
class MadFilterConfig:
    """One MAD outlier cut: keep points with 0.6745*|x-med|/MAD < threshold
    (reference pcl.remove_noise_by_mad, pcl.py:46-73)."""

    axis: int
    threshold: float


@dataclasses.dataclass(frozen=True)
class PlaneFitConfig:
    """Least-squares plane fit perpendicular to ``axis`` with residual-threshold
    inlier cut (reference pcl.remove_noise_by_fitting_plane, pcl.py:84-209)."""

    axis: int
    threshold: float
    plane_color: Tuple[int, int, int] = (255, 255, 255)


@dataclasses.dataclass(frozen=True)
class RoadDenoiseConfig:
    """The road denoise chain of semantic_depth.py:206-245.

    Order: z-window cut -> MAD(y) -> MAD(x) -> plane fit (axis=1) ->
    statistical outlier removal -> radius outlier removal.
    """

    # pcl.remove_from_to(road3D, colors, 2, 0.0, 7.0): the reference ignores
    # ``from_meter`` and keeps only z < -to_meter (pcl.py:30-43). We reproduce
    # that exact semantics.
    z_keep_beyond: float = 7.0
    mad_y: MadFilterConfig = MadFilterConfig(axis=1, threshold=15.0)
    mad_x: MadFilterConfig = MadFilterConfig(axis=0, threshold=2.0)
    plane: PlaneFitConfig = PlaneFitConfig(axis=1, threshold=5.0, plane_color=(200, 200, 200))
    # Open3D statistical_outlier_removal(nb_neighbors=10, std_ratio=0.5)
    # then radius_outlier_removal(nb_points=80, radius=0.5)
    # (semantic_depth.py:227-245).
    stat_nb_neighbors: int = 10
    stat_std_ratio: float = 0.5
    # 'grid': windowed kNN stencil over the image grid (fast TPU path, exact
    # for dense road clouds); 'exact': O(N^2) MXU distance matrix.
    stat_mode: str = "grid"
    stat_window: Tuple[int, int] = (5, 21)
    radius_nb_points: int = 80
    radius: float = 0.5
    # Fixed capacity for the compacted road cloud fed to the O(N^2) neighbor
    # kernels. Static shape for XLA; masked slots are inert.
    neighbor_capacity: int = 16384


@dataclasses.dataclass(frozen=True)
class FenceDenoiseConfig:
    """Fence denoise chain for the f2f approach (semantic_depth.py:273-309)."""

    mad_y: MadFilterConfig = MadFilterConfig(axis=1, threshold=5.0)
    z_abs_threshold: float = 35.0  # pcl.threshold_complete(..., 2, 35.0)
    mad_x_left: MadFilterConfig = MadFilterConfig(axis=0, threshold=5.0)
    mad_x_right: MadFilterConfig = MadFilterConfig(axis=0, threshold=1.0)
    plane_left: PlaneFitConfig = PlaneFitConfig(axis=0, threshold=1.0, plane_color=(40, 70, 40))
    plane_right: PlaneFitConfig = PlaneFitConfig(axis=0, threshold=1.0, plane_color=(40, 70, 40))


@dataclasses.dataclass(frozen=True)
class SegmenterConfig:
    """FCN-8s segmentation settings (reference fcn8s/fcn.py)."""

    num_classes: int = 3  # road / fence / background
    threshold: float = 0.5  # softmax probability cut (semantic_depth.py:556,564)
    # RGBA overlay colors; reference road [128,64,128,64] everywhere, fence
    # differs between entry points: [160,10,10,64] (semantic_depth.py:565) vs
    # [190,153,153,64] (sequence seq:480 and fcn.py:457).
    road_rgba: Tuple[int, int, int, int] = (128, 64, 128, 64)
    fence_rgba: Tuple[int, int, int, int] = (160, 10, 10, 64)


@dataclasses.dataclass(frozen=True)
class MonodepthConfig:
    """Monodepth disparity-network settings.

    Consumed surface in the reference: monodepth_parameters namedtuple
    (semantic_depth.py:609-622), test-mode forward returning
    ``disp_left_est[0]`` with flip-averaged post-processing
    (semantic_depth.py:656-678).
    """

    encoder: str = "vgg"  # 'vgg' | 'resnet50'
    # NOTE: the network input size comes from PipelineConfig.input_height/
    # input_width — it is NOT configured here (the reference's
    # monodepth_parameters height/width fields map to those).
    # Reference test mode always runs the frame + its horizontal flip as a
    # batch of 2 and blends (semantic_depth.py:656-678) — it compensates the
    # published nets' left-edge disocclusion artifacts. Costs a full second
    # forward pass. The supervised scene-trained native sets don't exhibit
    # the artifact (bench measures rw MAE either way), so the native
    # full-res mode may disable it; reference presets keep it on.
    flip_average: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline configuration (FrameProcessor equivalents,
    semantic_depth.py:81-460 and seq:103-376)."""

    camera: CameraConfig = CAMERA_MUNICH
    segmenter: SegmenterConfig = SegmenterConfig()
    monodepth: MonodepthConfig = MonodepthConfig()
    road: RoadDenoiseConfig = RoadDenoiseConfig()
    fence: FenceDenoiseConfig = FenceDenoiseConfig()
    input_height: int = 256
    input_width: int = 512
    approach: str = "both"  # 'rw' | 'both'
    depth: float = 10.0
    # rw slab center is depth-0.02 (semantic_depth.py:255) with +-0.05 window
    # (pcl.py:283).
    rw_depth_offset: float = 0.02
    rw_slab_halfwidth: float = 0.05
    # Road-width estimator. 'slab_minmax' is the reference's: min/max x of
    # the MEASURED points in the z-slab (pcl.py:271-313) — an extreme
    # statistic that inherits the disparity network's per-pixel noise.
    # 'plane_edge' (the native full-res mode) intersects pixel rays with the
    # fitted road plane and line-fits the mask edge per side
    # (ops/pcl.plane_edge_width) — reference-divergent, so opt-in.
    rw_estimator: str = "slab_minmax"
    # plane_edge aggregates edge rows in a +-halfwidth slab around depth;
    # wider than the 5 cm measurement slab because plane-ray geometry is
    # noise-free per row and more rows average the mask quantization.
    rw_plane_edge_halfwidth: float = 0.5
    # plane_edge drops pixels whose MEASURED range disagrees with the
    # plane-ray range by more than this (meters): segmentation false
    # positives at the mask boundary carry interpolated disparities that
    # scatter off the plane — the same property that keeps them out of the
    # slab estimator's narrow measured-z window (pipeline._road_width).
    rw_plane_edge_range_tol: float = 0.25
    # Disparity multiplier: the single-image entry uses the ORIGINAL frame
    # width (semantic_depth.py:109,145); the sequence entry hardcodes 3800
    # (seq:105). None => use original width.
    disparity_multiplier: Optional[float] = None
    # Compute dtype for the network forwards. Geometry always runs f32.
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """FCN-8s training hyperparameters (reference fcn.py:618-624, thesis
    Table 5)."""

    learning_rate: float = 1e-5
    dropout: float = 0.5  # keep_prob-style: probability of KEEPING a unit
    batch_size: int = 1
    num_classes: int = 3
    epochs: int = 100
    image_shape: Tuple[int, int] = (256, 512)  # (H, W)
    l2_scale: float = 1e-3  # decoder kernel L2 regularizer (fcn.py:162)
    init_stddev: float = 0.01  # truncated-normal init (fcn.py:161)


def munich_pipeline_config(**overrides) -> PipelineConfig:
    """Preset matching `python semantic_depth.py` defaults
    (semantic_depth.py:706-767)."""
    return dataclasses.replace(PipelineConfig(camera=CAMERA_MUNICH), **overrides)


def cityscapes_pipeline_config(**overrides) -> PipelineConfig:
    """Preset matching `--is_city` (semantic_depth.py:592-599)."""
    return dataclasses.replace(PipelineConfig(camera=CAMERA_CITYSCAPES), **overrides)


def sequence_pipeline_config(**overrides) -> PipelineConfig:
    """Preset matching semantic_depth_cityscapes_sequence.py defaults
    (seq:103-117, 500-508, 620)."""
    cfg = PipelineConfig(
        camera=CAMERA_CITYSCAPES_SEQUENCE,
        approach="rw",
        disparity_multiplier=3800.0,
        segmenter=SegmenterConfig(fence_rgba=(190, 153, 153, 64)),
    )
    return dataclasses.replace(cfg, **overrides)
