"""The port's native PLY writer and reader (``native/``, g++ at first use)
against its numpy path and the JAX package's ``io/ply.py`` on the CPU."""

import numpy as np
import pytest

from semantic_depth_tpu.io import ply as jply
from semantic_depth_tpu_torch.io import ply as tply
from semantic_depth_tpu_torch.native import build as native


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, 30.0, (n, 3)) * rng.choice([1e-4, 1.0, 1e3], (n, 1))
    pts[: n // 10, 2] = pts[:, 2].min() - 1.0 if n else 0.0  # the infinity filter's rows
    cols = rng.integers(0, 256, (n, 3)).astype(np.float64)
    return pts.astype(np.float32), cols


@pytest.mark.parametrize("n", [0, 1, 5000])
def test_native_writer_bytes_equal_numpy_and_jax(tmp_path, n):
    assert native.library() is not None, "g++ builds the native library here"
    pts, cols = _cloud(n, seed=n)
    before = tply._native_write.calls
    got = tply.write_ply(pts, cols, str(tmp_path / "native"))
    assert tply._native_write.calls == before + 1
    want_jax = jply.write_ply(pts, cols, str(tmp_path / "jax"))
    cloud = tply.PlyCloud(pts, cols, "")
    keep = cloud.points3d[:, 2] > cloud.points3d[:, 2].min() if n else slice(None)
    rows = cloud.points3d[keep]
    tply._numpy_write(str(tmp_path / "numpy.ply"), tply._PLY_HEADER.format(vertex_count=len(rows)),
                      rows, cloud.colors[keep])
    data = open(got, "rb").read()
    assert data == open(want_jax, "rb").read()
    assert data == (tmp_path / "numpy.ply").read_bytes()
    assert f"element vertex {len(rows)}".encode() in data


def test_native_reader_equals_jax(tmp_path):
    pts, cols = _cloud(3000, seed=7)
    path = tply.write_ply(pts, cols, str(tmp_path / "c"))
    got, want = tply.read_ply(path), jply.read_ply(path)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (2700, 3)
    # a vertex element with extra properties and a face element after it
    text = ("ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\nproperty float y\n"
            "property float z\nproperty float nx\nelement face 1\nproperty list uchar int v\n"
            "end_header\n1 2 3 9\n4 5 6 9\n3 0 1 1\n")
    (tmp_path / "extra.ply").write_text(text)
    for g, w in zip(tply.read_ply(str(tmp_path / "extra.ply")),
                    jply.read_ply(str(tmp_path / "extra.ply"))):
        np.testing.assert_array_equal(g, w)


def test_second_use_does_not_rebuild(monkeypatch):
    path = native.build()
    mtime = path.stat().st_mtime_ns

    def no_compiler(*args, **kwargs):
        raise AssertionError("g++ ran again")

    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    assert native.build() == path and path.stat().st_mtime_ns == mtime
    assert native.library() is native.library()
