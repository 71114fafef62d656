"""3D-consistent road scenes with analytic ground truth, rendered on the device.

A copy of the port's scene generator (``semantic_depth_tpu_torch/utils/
bench_scenes.py``), written in torch so that a run renders its frame pool
on the card in a fraction of a second. A pinhole camera at 1.5 m over a
ground plane sees a road corridor of known width between two vertical
fence planes: every pixel has an analytic disparity and class, and each
scene an exact road width (rw) and fence-to-fence distance (f2f).

The scene parameters of a pool of ``n`` are a fixed set, the same for every
seed (road widths evenly over 3.5-4.5 m, fence offsets over 3.2-3.8 m,
heights over 1.5-2.5 m, camera offsets over +-0.3 m, paired by fixed
strides); the seed orders them and draws the colours, the texture and the
0.1% disparity noise. So every seed gives the tail the same work.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

REF_H, REF_W = 256, 512
ROAD, FENCE, BACKGROUND = 7, 13, 22  # Cityscapes label ids


@dataclasses.dataclass(frozen=True)
class SceneParams:
    road_width: float
    cam_height: float
    fence_x: float
    fence_height: float
    center_jitter: float


def pool_params(n: int, gen: torch.Generator) -> List[SceneParams]:
    """The pool's fixed set of scenes in an order drawn from ``gen``."""
    def at(i, stride, lo, span):
        return lo + span * (((stride * i) % n) + 0.5) / n

    scenes = [SceneParams(road_width=at(i, 1, 3.5, 1.0), cam_height=1.5,
                          fence_x=at(i, 3, 3.2, 0.6), fence_height=at(i, 5, 1.5, 1.0),
                          center_jitter=at(i, 7, -0.3, 0.6)) for i in range(n)]
    order = torch.randperm(n, generator=gen, device=gen.device).tolist()
    return [scenes[i] for i in order]


def render(p: SceneParams, h: int, w: int, camera, gen: torch.Generator,
           disparity_mult: float = 2048.0, disp_noise: float = 0.001, image: bool = True):
    """One scene at (h, w) on ``gen``'s device: (BGR uint8 (h, w, 3) or None,
    labels (h, w) uint8, normalised disparity (h, w) float32 (pixels over
    disparity_mult * w / 512), rw, f2f)."""
    dev = gen.device
    s_w, s_h = w / float(REF_W), h / float(REF_H)
    focal, cx, cy = camera["focal"] * s_w, camera["cx"] * s_w, camera["cy"] * s_h
    f64 = torch.float64
    u = torch.arange(w, dtype=f64, device=dev)[None, :] - cx
    v = cy - torch.arange(h, dtype=f64, device=dev)[:, None]
    ninf = torch.tensor(float("-inf"), dtype=f64, device=dev)
    z_ground = torch.where(v < 0, focal * p.cam_height / v, ninf).expand(h, w)
    zf = torch.full((h, w), float("-inf"), dtype=f64, device=dev)
    fence_raw = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for side in (-1.0, 1.0):
        x_plane = side * p.fence_x - p.center_jitter
        z_side = torch.where(torch.sign(u) == (1.0 if x_plane > 0 else -1.0),
                             -focal * x_plane / u, ninf).expand(h, w)
        y_at = v * (-z_side) / focal
        on = (torch.isfinite(z_side) & (z_side < 0) & (y_at >= -p.cam_height)
              & (y_at <= -p.cam_height + p.fence_height))
        closer = on & (z_side > zf)
        zf = torch.where(closer, z_side, zf)
        fence_raw |= closer
    ground_vis = (z_ground < 0) & (z_ground >= zf)
    fence_vis = fence_raw & (zf > z_ground)
    nan = torch.tensor(float("nan"), dtype=f64, device=dev)
    z = torch.where(fence_vis, zf, torch.where(ground_vis, z_ground, nan))
    x3 = u * (-z) / focal
    road = ground_vis & ((x3 + p.center_jitter).abs() < p.road_width / 2.0)
    labels = torch.full((h, w), BACKGROUND, dtype=torch.uint8, device=dev)
    labels[road] = ROAD
    labels[fence_vis] = FENCE
    finite = torch.isfinite(z)
    d_px = torch.where(finite, focal * camera["baseline"] / torch.clamp(-z, min=1e-6), 0.0)
    if disp_noise:
        d_px = d_px * (1.0 + disp_noise * torch.randn((h, w), generator=gen, device=dev,
                                                      dtype=f64))
    disp_norm = (torch.clamp(d_px, min=0.5 * s_w) / (disparity_mult * s_w)).float()
    img = None
    if image:
        ys = torch.arange(h, dtype=f64, device=dev)[:, None]
        grad = torch.clamp(ys / max(h - 1, 1), 0, 1).expand(h, w)
        img = torch.zeros((h, w, 3), dtype=f64, device=dev)
        sky = ~finite
        img[sky] = (200 - 80 * grad)[sky][:, None]
        img[..., 0] += torch.where(sky, 30.0, 0.0)
        img[ground_vis & ~road] = 100.0
        colours = torch.randint(0, 30, (2,), generator=gen, device=dev).to(f64)
        img[road] = 60.0 + colours[0]
        img[fence_vis] = 140.0 + colours[1]
        shade = torch.clamp(1.0 - torch.where(finite, -z, 0.0) / 120.0, 0.55, 1.0)
        img = img * shade[..., None] + 4.0 * torch.randn((h, w, 3), generator=gen, device=dev,
                                                         dtype=f64)
        img = torch.clamp(img, 0, 255).to(torch.uint8)
    return img, labels, disp_norm, p.road_width, 2.0 * p.fence_x


def render_pool(params: List[SceneParams], h: int, w: int, camera, gen: torch.Generator,
                image: bool = True, disparity_mult: float = 2048.0):
    """The scenes stacked: (images or None, labels, disp_norm, rw, f2f)."""
    parts = [render(p, h, w, camera, gen, disparity_mult, image=image) for p in params]
    imgs = torch.stack([q[0] for q in parts]) if image else None
    return (imgs, torch.stack([q[1] for q in parts]), torch.stack([q[2] for q in parts]),
            [q[3] for q in parts], [q[4] for q in parts])
