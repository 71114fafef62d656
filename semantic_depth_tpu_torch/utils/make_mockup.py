"""Generate a Cityscapes-layout mockup dataset (port of
``semantic_depth_tpu/utils/make_mockup.py``, a copy: the same seed writes the
same PNG bytes). The reference ships data/roborace750_mockup as its
train/val/test fixture.

Produces synthetic road scenes: a textured ground plane with a road
trapezoid (label id 7), fence bands (id 13), and sky/background — enough for
the FCN CLI to train and evaluate end to end without real data.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _scene(rng, h, w):
    img = np.zeros((h, w, 3), np.uint8)
    ids = np.full((h, w), 22, np.uint8)  # background
    horizon = h // 2
    # sky gradient
    img[:horizon] = np.linspace(200, 120, horizon)[:, None, None].astype(np.uint8)
    # ground
    img[horizon:] = 100
    ys = np.arange(h)[:, None]
    xs = np.arange(w)[None, :]
    # road trapezoid: widens toward the bottom
    center = w / 2 + rng.uniform(-w * 0.05, w * 0.05)
    spread = (ys - horizon) / (h - horizon + 1e-9)
    halfwidth = np.clip(spread, 0, 1) * w * rng.uniform(0.25, 0.35)
    road = (ys >= horizon) & (np.abs(xs - center) < halfwidth)
    img[road] = rng.integers(60, 90)
    ids[road] = 7
    # fences: vertical bands just outside the road, above ground rows
    fence_w = int(w * 0.06)
    for side in (-1, 1):
        edge = int(center + side * w * rng.uniform(0.36, 0.42))
        x0, x1 = sorted((edge, edge + side * fence_w))
        x0, x1 = max(0, x0), min(w, x1)
        band = (xs >= x0) & (xs < x1) & (ys >= horizon - h // 6) & (ys < h - h // 8)
        img[band] = rng.integers(140, 170)
        ids[band] = 13
    noise = rng.integers(-12, 12, img.shape)
    img = np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)
    return img, ids


def make_mockup(out_dir: str, dataset: str = "roborace_mockup",
                counts=(6, 2, 2), hw=(256, 512), seed: int = 0) -> str:
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = hw
    root = os.path.join(out_dir, dataset)
    for split, n in zip(("train", "val", "test"), counts):
        img_dir = os.path.join(root, "leftImg8bit", split, "mockup")
        gt_dir = os.path.join(root, "gtFine", split, "mockup")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(gt_dir, exist_ok=True)
        for i in range(n):
            img, ids = _scene(rng, h, w)
            base = f"mockup_{i:06d}_000019"
            Image.fromarray(img).save(os.path.join(img_dir, f"{base}_leftImg8bit.png"))
            Image.fromarray(ids).save(  # a 2-D uint8 array is mode "L"
                os.path.join(gt_dir, f"{base}_gtFine_labelIds.png")
            )
    return root


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate a Cityscapes-layout mockup dataset.")
    p.add_argument("--out_dir", default="data")
    p.add_argument("--dataset", default="roborace_mockup")
    p.add_argument("--train", type=int, default=6)
    p.add_argument("--val", type=int, default=2)
    p.add_argument("--test", type=int, default=2)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    root = make_mockup(
        args.out_dir, args.dataset, (args.train, args.val, args.test),
        (args.height, args.width), args.seed,
    )
    print(f"mockup dataset at {root}")


if __name__ == "__main__":
    main()
