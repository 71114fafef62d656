"""3D-consistent synthetic road scenes with ANALYTIC ground truth.

numpy-only copy of ``semantic_depth_tpu/utils/bench_scenes.py`` for the
PyTorch port (same seeds give the same scenes).

``utils.make_mockup`` draws plausible-looking road trapezoids for the FCN
training fixture; this module instead *renders a true 3D scene* through the
pipeline's own pinhole model (camera.reproject_disparity semantics,
semantic_depth.py:691-697): a ground plane at a fixed camera height carrying
a constant-width road corridor, plus two vertical fence planes. Every pixel
therefore has an analytic disparity, class label, and the scene has an exact
road width — which makes these scenes usable as *correctness oracles* for
the full pipeline (the bench trains the two networks on them and checks the
measured ``dist_rw`` against ``rw_true``; the reference's own accuracy
protocol is the Munich hand-measured sweep, semantic_depth.py:903-937).

Geometry conventions (camera.py): X right, Y up, Z toward the viewer
(visible points have z < 0); disparity d = f*b/(-z) pixels; the pipeline's
network-facing disparity is normalized by the disparity multiplier
(pipeline.disparity: d_pixels = net_output * mult * s_w).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..config import CAMERA_MUNICH, CameraConfig

_REF_H, _REF_W = 256, 512  # the reference networks' working resolution


@dataclasses.dataclass(frozen=True)
class SceneParams:
    road_width: float  # meters, exact corridor width == rw ground truth
    cam_height: float  # meters above the ground plane (road plane y = -cam_height)
    fence_x: float  # |X| of the two vertical fence planes
    fence_height: float  # meters of fence above ground
    center_jitter: float  # lateral camera offset (m) within the corridor


def sample_params(rng: np.random.Generator) -> SceneParams:
    return SceneParams(
        road_width=float(rng.uniform(3.5, 4.5)),
        cam_height=1.5,
        fence_x=float(rng.uniform(3.2, 3.8)),
        fence_height=float(rng.uniform(1.5, 2.5)),
        center_jitter=float(rng.uniform(-0.3, 0.3)),
    )


def scaled_camera(camera: CameraConfig, h: int, w: int) -> CameraConfig:
    """Intrinsics at (h, w), scaled from the reference 256x512 calibration —
    mirrors pipeline._scaled_camera so rendered scenes match the pipeline's
    back-projection at any working resolution."""
    s_w = w / float(_REF_W)
    s_h = h / float(_REF_H)
    return dataclasses.replace(
        camera, focal=camera.focal * s_w, cx=camera.cx * s_w, cy=camera.cy * s_h
    )


def render_scene(
    rng: np.random.Generator,
    h: int,
    w: int,
    params: Optional[SceneParams] = None,
    camera: CameraConfig = CAMERA_MUNICH,
    disparity_mult: float = 2048.0,
    disp_noise: float = 0.001,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float, float]:
    """Render one scene at (h, w).

    Returns (img_bgr_uint8 (h,w,3), label_ids (h,w) uint8 Cityscapes ids
    {road 7, fence 13, background 22}, disp_norm (h,w) f32 — the NORMALIZED
    disparity the monodepth net should output at this resolution (pixels /
    (disparity_mult * s_w), matching pipeline.disparity's scaling),
    rw_true — the exact road width in meters — and f2f_true, the exact
    fence-to-fence distance 2*fence_x: the camera jitter shifts both planes
    equally, so their separation is jitter-free).
    """
    if params is None:
        params = sample_params(rng)
    cam = scaled_camera(camera, h, w)
    s_w = w / float(_REF_W)

    xs = np.arange(w, dtype=np.float64)[None, :]
    ys = np.arange(h, dtype=np.float64)[:, None]
    u = xs - cam.cx  # (1, w)
    v = cam.cy - ys  # (h, 1); v < 0 below the principal row

    # Surface 1: ground plane Y = -cam_height. Y = v * (-z) / f  =>
    # z_ground = -f * cam_height / (-v) for v < 0 (below the horizon).
    with np.errstate(divide="ignore", invalid="ignore"):
        z_ground = np.where(v < 0, cam.focal * params.cam_height / v, -np.inf)
    z_ground = np.broadcast_to(z_ground, (h, w))

    # Surface 2/3: vertical fence planes X = +-fence_x (+ camera jitter).
    # X = u * (-z) / f  =>  z_fence = -f * X_plane / u (same sign side only).
    zf = np.full((h, w), -np.inf)
    fence_mask_raw = np.zeros((h, w), bool)
    for side in (-1.0, 1.0):
        x_plane = side * params.fence_x - params.center_jitter
        with np.errstate(divide="ignore", invalid="ignore"):
            z_side = -cam.focal * x_plane / u
        z_side = np.broadcast_to(np.where(np.sign(u) == np.sign(x_plane), z_side, -np.inf), (h, w))
        # fence spans Y in [-cam_height, -cam_height + fence_height] at its z
        y_at = v * (-z_side) / cam.focal
        on_fence = (
            np.isfinite(z_side)
            & (z_side < 0)
            & (y_at >= -params.cam_height)
            & (y_at <= -params.cam_height + params.fence_height)
        )
        closer = on_fence & (z_side > zf)
        zf = np.where(closer, z_side, zf)
        fence_mask_raw |= closer

    # Visibility: nearest surface (largest z < 0). The fence planes sit
    # outside the road corridor, so they occlude ground behind them.
    ground_vis = (z_ground < 0) & (z_ground >= zf)
    fence_vis = fence_mask_raw & (zf > z_ground)
    z = np.where(fence_vis, zf, np.where(ground_vis, z_ground, np.nan))

    # Road corridor on the visible ground: |X + jitter| < road_width / 2.
    x3 = u * (-z) / cam.focal
    road = ground_vis & (np.abs(x3 + params.center_jitter) < params.road_width / 2.0)

    labels = np.full((h, w), 22, np.uint8)
    labels[road] = 7
    labels[fence_vis] = 13

    # Normalized disparity (what the net must output BEFORE the pipeline's
    # * disparity_mult * s_w scaling). Sky/void gets a tiny far value.
    d_px = np.where(np.isfinite(z), cam.focal * cam.baseline / np.maximum(-z, 1e-6), 0.0)
    far_px = 0.5 * s_w  # sub-pixel: back-projects far beyond the z-window
    # Small relative depth noise: a perfectly planar cloud has MAD == 0 in Y
    # and the reference's MAD quirk (penalty = x/0 -> inf/nan, pcl.py:63)
    # would drop EVERY point; real sensors always carry jitter. 0.1% keeps
    # the min/max-x endpoint bias below ~1 cm.
    if disp_noise:
        d_px = d_px * (1.0 + rng.normal(0.0, disp_noise, size=d_px.shape))
    disp_norm = (np.maximum(d_px, far_px) / (disparity_mult * s_w)).astype(np.float32)

    # --- appearance: flat-shaded surfaces + texture noise (BGR uint8) ---
    img = np.zeros((h, w, 3), np.float64)
    sky = ~np.isfinite(z)
    grad = np.clip((ys - 0) / max(h - 1, 1), 0, 1)
    img[sky] = (np.broadcast_to(200 - 80 * grad, (h, w))[sky])[:, None]
    img[sky, 0] += 30  # bluish sky (BGR)
    ground_only = ground_vis & ~road
    img[ground_only] = 100
    img[road] = rng.integers(60, 90)
    img[fence_vis] = rng.integers(140, 170)
    # depth shading so the nets see distance cues beyond the horizon line
    shade = np.clip(1.0 - np.where(np.isfinite(z), -z, 0.0) / 120.0, 0.55, 1.0)
    img *= shade[..., None]
    img += rng.normal(0.0, 4.0, size=img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img, labels, disp_norm, params.road_width, 2.0 * params.fence_x


def scene_pool(
    n: int,
    h: int,
    w: int,
    seed: int = 0,
    camera: CameraConfig = CAMERA_MUNICH,
    disparity_mult: float = 2048.0,
):
    """n scenes: returns (imgs (n,h,w,3) uint8, labels (n,h,w) uint8,
    disp_norm (n,h,w) f32, rw_true (n,) f32, f2f_true (n,) f32)."""
    rng = np.random.default_rng(seed)
    imgs, labels, disps, rws, f2fs = [], [], [], [], []
    for _ in range(n):
        i, l, d, r, f2 = render_scene(rng, h, w, camera=camera, disparity_mult=disparity_mult)
        imgs.append(i)
        labels.append(l)
        disps.append(d)
        rws.append(r)
        f2fs.append(f2)
    return (
        np.stack(imgs),
        np.stack(labels),
        np.stack(disps),
        np.asarray(rws, np.float32),
        np.asarray(f2fs, np.float32),
    )
