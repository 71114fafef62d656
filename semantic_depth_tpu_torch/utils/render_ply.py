"""Offscreen point-cloud rendering (port of ``semantic_depth_tpu/utils/render_ply.py``;
reference utils/render_ply.py:7-58, which rendered result PLYs with Open3D's
Visualizer).

A z-buffer point splatter: every point is projected with a pinhole camera,
``scatter_reduce(..., "amin")`` keeps each pixel's nearest depth, and a
second scatter of point indices (``"amin"`` over the points at that depth)
picks each pixel's winner, whose color is gathered. The winner is the
first of the nearest points, on the card as on the CPU. Runs on the card
unless the caller asks for the CPU.

    python -m semantic_depth_tpu_torch.utils.render_ply cloud.ply --out_dir renders
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..runtime import resolve_device


def _splat(pts: torch.Tensor, cols: torch.Tensor, h: int, w: int, focal: float,
           look_forward_z: float, background: float) -> torch.Tensor:
    """(N, 3) camera-relative points and colors -> (h, w, 3) float32."""
    n = pts.shape[0]
    z = pts[:, 2] * look_forward_z  # depth along the view direction, > 0 in front
    valid = z > 0.1
    zs = torch.where(valid, z, float("inf"))
    u = torch.div(pts[:, 0], zs) * focal + w / 2.0
    v = torch.div(-pts[:, 1], zs) * focal + h / 2.0
    ui, vi = torch.round(u), torch.round(v)  # half to even, like jnp.round
    inside = valid & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    flat = torch.where(inside, vi * w + ui, float(h * w)).long()  # slot h*w: dropped
    zbuf = torch.full((h * w + 1,), float("inf"), device=pts.device)
    zbuf = zbuf.scatter_reduce(0, flat, zs, "amin")
    won = inside & (zs <= zbuf[flat])
    winner = torch.full((h * w + 1,), n, dtype=torch.long, device=pts.device)
    winner = winner.scatter_reduce(0, torch.where(won, flat, h * w),
                                   torch.arange(n, device=pts.device), "amin")
    palette = torch.cat([cols, torch.full((1, 3), float(background), device=pts.device)])
    return palette[winner[: h * w]].reshape(h, w, 3)


def render_points(
    points: np.ndarray,
    colors: np.ndarray,
    image_hw: Tuple[int, int] = (512, 1024),
    focal: float = 500.0,
    camera_pos: Optional[np.ndarray] = None,
    look_forward_z: float = -1.0,
    splat: int = 2,
    background: float = 255.0,
    device=None,
) -> np.ndarray:
    """Render (N, 3) points with (N, 3) 0..255 colors to an (H, W, 3) uint8
    image. The camera looks down +z*look_forward_z from ``camera_pos``
    (default slightly above the origin: the road recedes toward -z).
    ``splat`` > 1 dilates the painted pixels over the background (cv2) so
    sparse clouds stay visible. ``device`` None is the card."""
    dev = resolve_device(device)
    h, w = image_hw
    if camera_pos is None:
        camera_pos = np.array([0.0, 0.5, 1.0])
    pts = (torch.as_tensor(np.asarray(points, np.float32), device=dev)
           - torch.as_tensor(np.asarray(camera_pos, np.float32), device=dev))
    cols = torch.as_tensor(np.asarray(colors, np.float32), device=dev)
    out = _splat(pts, cols, h, w, float(focal), float(look_forward_z),
                 float(background)).cpu().numpy()
    if splat > 1:
        import cv2

        mask = np.all(out == background, axis=-1)
        dil = cv2.dilate(out.astype(np.uint8), np.ones((splat, splat), np.uint8))
        out = np.where(mask[..., None], dil, out)
    return np.clip(out, 0, 255).astype(np.uint8)


def render_ply_file(ply_path: str, png_path: str, **kwargs) -> str:
    """Render a PLY to a PNG whose pixels are what ``plt.imsave`` writes
    (RGBA, alpha 255), without matplotlib."""
    from ..cli.common import write_rgba_png
    from ..io.ply import read_ply

    pts, cols = read_ply(ply_path)
    img = render_points(pts, cols, **kwargs)
    write_rgba_png(png_path, np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)],
                                            -1))
    return png_path


def main(argv=None):
    p = argparse.ArgumentParser(description="Render PLY point clouds to PNG.")
    p.add_argument("plys", nargs="+", help="PLY files to render")
    p.add_argument("--out_dir", default=".")
    p.add_argument("--focal", type=float, default=500.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    for ply in args.plys:
        png = os.path.join(args.out_dir, os.path.splitext(os.path.basename(ply))[0] + ".png")
        print(render_ply_file(ply, png, focal=args.focal, device=args.device))


if __name__ == "__main__":
    main()
