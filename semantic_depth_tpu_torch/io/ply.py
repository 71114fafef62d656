"""ASCII PLY export and import, format-compatible with the reference writer
(semantic_depth_lib/point_cloud_2_ply.py:33-93); the port's copy of
``semantic_depth_tpu/io/ply.py``, numpy only.

Header layout (including the indented continuation lines produced by the
reference's triple-quoted header string) and the ``%f %f %f %d %d %d`` row
format are reproduced exactly, so the files are byte-equal to the JAX
package's. The "infinity filter" drops points whose z equals the cloud
minimum before saving (point_cloud_2_ply.py:87-90).
"""

from __future__ import annotations

import numpy as np

# The reference embeds the header as an indented triple-quoted string; the
# leading spaces on continuation lines are part of the file format it emits.
_PLY_HEADER = (
    "ply\n"
    "    format ascii 1.0\n"
    "    element vertex {vertex_count}\n"
    "    property float x\n"
    "    property float y\n"
    "    property float z\n"
    "    property uchar red\n"
    "    property uchar green\n"
    "    property uchar blue\n"
    "    end_header\n"
    "    "
)


class PlyCloud:
    """Accumulates (points, colors) blocks and writes one ASCII PLY.

    Mirrors PointCloud2Ply: ``add`` appends extra clouds, ``save`` applies the
    infinity filter and writes ``<output_name>.ply``.
    """

    def __init__(self, points3d: np.ndarray, colors: np.ndarray, output_name: str):
        self.points3d = np.asarray(points3d, np.float64).reshape(-1, 3)
        self.colors = np.asarray(colors, np.float64).reshape(-1, 3)
        self.output_name = output_name

    def add(self, points3d: np.ndarray, colors: np.ndarray) -> None:
        self.points3d = np.append(self.points3d, np.asarray(points3d).reshape(-1, 3), axis=0)
        self.colors = np.append(self.colors, np.asarray(colors).reshape(-1, 3), axis=0)

    def save(self) -> str:
        if self.points3d.shape[0] == 0:
            pts = self.points3d
            cols = self.colors
        else:
            # Infinity filter: drop points sitting at the minimum z.
            mask = self.points3d[:, 2] > self.points3d[:, 2].min()
            pts = self.points3d[mask]
            cols = self.colors[mask]
        path = f"{self.output_name}.ply"
        with open(path, "w") as f:
            f.write(_PLY_HEADER.format(vertex_count=len(pts)))
            np.savetxt(f, np.hstack([pts, cols]), "%f %f %f %d %d %d")
        return path


def write_ply(points3d, colors, output_name) -> str:
    return PlyCloud(points3d, colors, output_name).save()


def read_ply(path: str):
    """Read an ASCII PLY with x y z [red green blue] vertex properties.
    Returns (points (N, 3) f64, colors (N, 3) f64 or zeros). Only the vertex
    element's properties set the row width, and the vertex element must come
    first."""
    with open(path, "rb") as f:
        line = f.readline()
        if not line.startswith(b"ply"):
            raise ValueError(f"{path}: not a PLY file")
        n_vertices = 0
        props = []
        cur_element = None  # which element's property lines we are reading
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated header")
            tok = line.split()
            if not tok:
                continue
            if tok[0] == b"element":
                if tok[1] == b"vertex":
                    if cur_element is not None:
                        # an element declared before vertex means vertex rows
                        # are not first in the data section
                        raise ValueError(f"{path}: vertex element is not first in file")
                    n_vertices = int(tok[2])
                cur_element = tok[1]
            elif tok[0] == b"property" and cur_element == b"vertex":
                # later elements (e.g. faces) must not widen the row stride
                props.append(tok[2].decode())
            elif tok[0] == b"end_header":
                break
            elif tok[0] == b"format" and tok[1] != b"ascii":
                raise ValueError(f"{path}: only ascii PLY supported")
        if n_vertices == 0 or not props:
            data = np.zeros((n_vertices, max(len(props), 1)), np.float64)
        else:
            data = np.loadtxt(f, max_rows=n_vertices)
    data = np.atleast_2d(data)
    ix = [props.index(p) for p in ("x", "y", "z")]
    pts = data[:, ix]
    if all(p in props for p in ("red", "green", "blue")):
        cols = data[:, [props.index(p) for p in ("red", "green", "blue")]]
    else:
        cols = np.zeros_like(pts)
    return pts, cols
