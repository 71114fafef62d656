"""Statistical and radius outlier removal, the Open3D replacement (port of
``semantic_depth_tpu/ops/neighbors.py``).

The reference runs Open3D's KD-tree filters on the road cloud
(semantic_depth.py:227-245):

    statistical_outlier_removal(nb_neighbors=10, std_ratio=0.5)
    radius_outlier_removal(nb_points=80, radius=0.5)

with Open3D 0.x semantics (line-by-line notes in tests/oracles.py):

* statistical: the threshold is mean + std_ratio * sample std of the
  per-point mean kNN distances; the moments divide by the full count while
  their sums skip zero distances; a point survives iff 0 < d < threshold.
  The grid mode windows the kNN search on the image grid.
* radius: a point survives if the count of cloud points with squared
  distance STRICTLY below radius^2, itself included, exceeds ``nb_points``.

Every function takes a leading frame-batch dimension. On CUDA tensors the
kNN and radius counts launch the hand-written kernels (``ops/knn_grid.py``,
``ops/radius.py``), at the places where the JAX package dispatches to
Pallas; CPU tensors take their plain versions. The exact O(N^2) kNN mode
(``stat_mode="exact"``) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import knn_grid, radius
from .knn_grid import knn_mean_distances_grid
from .pcl import MaskedCloud

__all__ = [
    "knn_mean_distances_grid",
    "radius_counts",
    "radius_counts_weighted",
    "radius_outlier_filter",
    "statistical_outlier_filter_grid",
]


def radius_counts(cloud: MaskedCloud, radius_m: float) -> torch.Tensor:
    """Number of valid cloud points within ``radius_m`` of each point (self
    included); 0 on invalid rows. cloud: (B, C) rows."""
    w = cloud.valid.float()
    return radius.radius_counts(cloud.xyz, cloud.valid, w, radius_m).to(torch.int32)


def radius_counts_weighted(
    cloud: MaskedCloud, weights: torch.Tensor, radius_m: float
) -> torch.Tensor:
    """Sum of per-candidate ``weights`` within ``radius_m`` of each point
    (density-compensated counts); invalid rows contribute nothing and get 0."""
    return radius.radius_counts(cloud.xyz, cloud.valid, weights.float(), radius_m)


def statistical_outlier_filter_grid(
    points: torch.Tensor,
    valid: torch.Tensor,
    nb_neighbors: int,
    std_ratio: float,
    window: Tuple[int, int] = (5, 21),
) -> torch.Tensor:
    """Grid-windowed statistical outlier removal over (B, H, W) grids, with
    per-frame moments. Pixels without k candidates in the window get +inf
    and are left out of the moments. Returns the new (B, H, W) validity."""
    mean_d = knn_grid.knn_mean_distances_grid(points, valid, nb_neighbors, window)
    finite = valid & torch.isfinite(mean_d)
    pos = finite & (mean_d > 0)  # upstream skips avg == 0 rows in the sums
    dims = (-2, -1)
    n = finite.float().sum(dims, keepdim=True)
    mu = torch.where(pos, mean_d, 0.0).sum(dims, keepdim=True) / n
    var = torch.where(pos, (mean_d - mu) ** 2, 0.0).sum(dims, keepdim=True) / (n - 1.0)
    threshold = mu + std_ratio * torch.sqrt(var)
    return pos & (mean_d < threshold)


def radius_outlier_filter(
    cloud: MaskedCloud, nb_points: int, radius_m: float, weights=None
) -> MaskedCloud:
    """Open3D radius_outlier_removal (semantic_depth.py:238). ``weights``:
    optional per-candidate density compensation; each candidate within the
    radius contributes its weight instead of 1."""
    if weights is None:
        counts = radius_counts(cloud, radius_m)
    else:
        weights = torch.where(cloud.valid, weights.float(), 0.0)
        counts = radius_counts_weighted(cloud, weights, radius_m)
    return cloud.with_mask(cloud.valid & (counts > nb_points))
