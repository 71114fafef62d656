"""Result artifacts: timing/distance text files, sweep data files, and the
visualization geometry (plane meshes, measurement lines) the reference saves
alongside its PLY clouds. The port's copy of
``semantic_depth_tpu/io/artifacts.py`` (numpy only; the same bytes).

All output formats are byte-compatible with the reference writers:
* ``<out>_times.txt`` — 9 labeled wall-clock rows (semantic_depth.py:445-454)
* ``<out>_distances.txt`` — rw/f2f rows (semantic_depth.py:456-458)
* ``results/<f>/data.txt`` — np.savetxt %1.4f matrix with an MAE row
  appended (semantic_depth.py:907-936)
* ``results/best_focal_lengths.txt`` (semantic_depth.py:939-944)
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np


def write_times(output_name: str, times: Dict[str, float]) -> str:
    """times keys: read, semantic, disparity, to3D, road, rw, fences, f2f,
    global. Label text/padding matches semantic_depth.py:445-454."""
    path = f"{output_name}_times.txt"
    with open(path, "w") as f:
        f.write("Time read:       {}\n".format(times.get("read", 0.0)))
        f.write("Time semantic:   {}\n".format(times.get("semantic", 0.0)))
        f.write("Time disparity:  {}\n".format(times.get("disparity", 0.0)))
        f.write("Time to3D:       {}\n".format(times.get("to3D", 0.0)))
        f.write("Time road:       {}\n".format(times.get("road", 0.0)))
        f.write("Time rw:      {}\n".format(times.get("rw", 0.0)))
        f.write("Time fences:     {}\n".format(times.get("fences", 0.0)))
        f.write("Time f2f:   {}\n".format(times.get("f2f", 0.0)))
        f.write("Time global:     {}\n".format(times.get("global", 0.0)))
    return path


def write_distances(output_name: str, dist_rw: float, dist_f2f: float) -> str:
    path = f"{output_name}_distances.txt"
    with open(path, "w") as f:
        f.write("rw distance:    {}\n".format(dist_rw))
        f.write("f2f distance: {}\n".format(dist_f2f))
    return path


def write_sweep_data(f_directory: str, all_data: np.ndarray, n_frames: int) -> str:
    """Append the MAE row and save results/<f>/data.txt
    (semantic_depth.py:907-936). all_data rows: [real, rw, f2f, ae_rw, ae_f2f]."""
    all_data = np.asarray(all_data, np.float64)
    mae_rw = np.sum(all_data[:, 3]) / n_frames
    mae_f2f = np.sum(all_data[:, 4]) / n_frames
    mae_row = np.zeros((1, 5))
    mae_row[:, 3] = mae_rw
    mae_row[:, 4] = mae_f2f
    out = np.concatenate((all_data, mae_row))
    path = os.path.join(f_directory, "data.txt")
    np.savetxt(path, out, fmt="%1.4f")
    return path


def write_best_focal_lengths(
    results_directory: str, best_f_rw, best_f_f2f, best_f_overall
) -> str:
    path = os.path.join(results_directory, "best_focal_lengths.txt")
    with open(path, "w") as f:
        f.write("Best f road's width: {}\n".format(best_f_rw))
        f.write("Best f fence2fence:  {}\n".format(best_f_f2f))
        f.write("Best f overall:      {}\n".format(best_f_overall))
    return path


# ---------------------------------------------------------------------------
# Visualization geometry (host-side; dynamic sizes are fine off-device)
# ---------------------------------------------------------------------------


def plane_mesh(
    points3d: np.ndarray,
    coeffs: Sequence[float],
    axis: int,
    plane_color: Sequence[int],
    grid_size: float = 0.05,
):
    """Meshgrid sampling of a fitted plane over the cloud's bounding box, for
    PLY visualization (pcl.py:107-126 and the axis-1/2 variants).

    coeffs: (Cx, Cy, Cz, C) with coefficient of ``axis`` == -1; the plane is
    evaluated as coord_axis = C_u * u + C_v * v + C over the (u, v) bounding
    box of the cloud.
    """
    uv = {0: (1, 2), 1: (0, 2), 2: (0, 1)}[axis]
    if points3d.shape[0] == 0 or not np.all(np.isfinite(coeffs)):
        empty = np.zeros((0, 3))
        return empty, empty
    u = points3d[:, uv[0]]
    v = points3d[:, uv[1]]
    U, V = np.meshgrid(
        np.arange(u.min(), u.max(), grid_size), np.arange(v.min(), v.max(), grid_size)
    )
    coeffs = np.asarray(coeffs, np.float64)
    B = coeffs[uv[0]] * U + coeffs[uv[1]] * V + coeffs[3]
    cols = {axis: B, uv[0]: U, uv[1]: V}
    mesh = np.stack([cols[0].ravel(), cols[1].ravel(), cols[2].ravel()], axis=1)
    colors = np.ones_like(mesh) * np.asarray(plane_color, np.float64)
    return mesh, colors


def measurement_line(left_pt: np.ndarray, right_pt: np.ndarray, color: Sequence[int]):
    """1001-point lerp polyline between the endpoints, lifted 1 cm in y —
    matching pcl.create_3Dline_from_3Dpoints (pcl.py:321-330) including the
    duplicated first vertex."""
    left = np.asarray(left_pt, np.float64).reshape(1, 3).copy()
    right = np.asarray(right_pt, np.float64).reshape(1, 3).copy()
    if not (np.all(np.isfinite(left)) and np.all(np.isfinite(right))):
        empty = np.zeros((0, 3))
        return empty, empty
    left[0, 1] += 0.01
    right[0, 1] += 0.01
    t = np.arange(0.0, 1.0, 0.001)[:, None]
    line = np.concatenate([left, left + t * (right - left)], axis=0)
    colors = np.ones_like(line) * np.asarray(color, np.float64)
    return line, colors
