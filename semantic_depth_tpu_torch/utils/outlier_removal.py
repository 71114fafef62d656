"""Statistical + radius outlier removal over a PLY file (port of
``semantic_depth_tpu/utils/outlier_removal.py``; reference
utils/outlier_removal.py:1-53, which used Open3D).

Reads a PLY, runs the exact statistical filter (the exact kNN kernel,
``ops/exact_knn.py``) and then the unweighted radius filter (the radius
kernel, ``ops/radius.py``) on the card, and writes the inliers (optionally
followed by the removed points painted red).

    python -m semantic_depth_tpu_torch.utils.outlier_removal noisy.ply --out clean.ply
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..io.ply import PlyCloud, read_ply
from ..ops import neighbors
from ..ops.pcl import MaskedCloud
from ..runtime import resolve_device


def filter_ply(
    ply_path: str,
    out_path: str,
    nb_neighbors: int = 10,
    std_ratio: float = 0.5,
    nb_points: int = 80,
    radius: float = 0.5,
    save_outliers: bool = False,
    device=None,
) -> str:
    """Filter one PLY and write the result; returns the written path. The
    cloud goes to the kernels as one frame of capacity the next power of
    two >= max(n, 1024). ``device`` None is the card."""
    dev = resolve_device(device)
    pts, cols = read_ply(ply_path)
    n = pts.shape[0]
    cap = 1 << max(10, (n - 1).bit_length())  # next pow2 capacity
    xyz = np.zeros((cap, 3), np.float32)
    rgb = np.zeros((cap, 3), np.float32)
    xyz[:n] = pts
    rgb[:n] = cols
    cloud = MaskedCloud(
        xyz=torch.from_numpy(xyz)[None].to(dev),
        rgb=torch.from_numpy(rgb)[None].to(dev),
        valid=(torch.arange(cap) < n)[None].to(dev),
    )
    filtered = neighbors.statistical_outlier_filter(cloud, nb_neighbors, std_ratio)
    filtered = neighbors.radius_outlier_filter(filtered, nb_points, radius)
    valid = filtered.valid[0].cpu().numpy()
    inliers = PlyCloud(xyz[valid], rgb[valid], out_path.removesuffix(".ply"))
    if save_outliers:
        out_mask = (~valid) & (np.arange(cap) < n)
        red = np.zeros((out_mask.sum(), 3))
        red[:, 0] = 255.0
        inliers.add(xyz[out_mask], red)
    print(f"{ply_path}: kept {int(valid.sum())}/{n} points")
    return inliers.save()


def main(argv=None):
    p = argparse.ArgumentParser(description="Statistical + radius outlier removal demo.")
    p.add_argument("ply", help="input PLY")
    p.add_argument("--out", default="inliers.ply")
    p.add_argument("--nb_neighbors", type=int, default=10)
    p.add_argument("--std_ratio", type=float, default=0.5)
    p.add_argument("--nb_points", type=int, default=80)
    p.add_argument("--radius", type=float, default=0.5)
    p.add_argument("--show_outliers", action="store_true",
                   help="append removed points painted red")
    args = p.parse_args(argv)
    filter_ply(args.ply, args.out, args.nb_neighbors, args.std_ratio,
               args.nb_points, args.radius, args.show_outliers)


if __name__ == "__main__":
    main()
