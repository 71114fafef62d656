"""The port's other entry points on the CPU: ``process_frame_staged`` against
``process_frame`` and the JAX staged run, the PLY writer and reader against
the JAX package's, and the outlier-removal entry point against the JAX one."""

import dataclasses

import numpy as np
import pytest
import torch

from semantic_depth_tpu import config as jconfig
from semantic_depth_tpu import pipeline as jpipeline
from semantic_depth_tpu.io import ply as jply
from semantic_depth_tpu.models import FCN8s as JaxFCN8s
from semantic_depth_tpu.models import Monodepth as JaxMonodepth
from semantic_depth_tpu.utils import outlier_removal as joutlier
from semantic_depth_tpu_torch import config as tconfig
from semantic_depth_tpu_torch import pipeline as tpipeline
from semantic_depth_tpu_torch.io import ply as tply
from semantic_depth_tpu_torch.models import FCN8s, Monodepth
from semantic_depth_tpu_torch.models.from_flax import load_flax
from semantic_depth_tpu_torch.ops import pcl
from semantic_depth_tpu_torch.utils import outlier_removal as toutlier
from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

from torch_helpers import numpy_params

torch.set_num_threads(2)  # six xdist workers share the machine

# puts the tiny random networks' road 8-9 m away: past the 7 m cut, with a
# road cloud of 300-1100 points left after the statistical and radius filters
_MULT = 300.0


def _tiny_cfg(config_mod, stat_mode, approach="both"):
    base = config_mod.munich_pipeline_config()
    return config_mod.munich_pipeline_config(
        input_height=128, input_width=256, approach=approach,
        road=dataclasses.replace(base.road, neighbor_capacity=2048, stat_mode=stat_mode),
    )


@pytest.fixture(scope="module")
def tiny():
    """Numpy-seeded parameters of the tiny networks of tests/test_pipeline.py,
    a frame, and the JAX pipeline's staged run on it (exact mode)."""
    jfcn = JaxFCN8s(num_classes=3, width_mult=0.0625, fc_channels=32)
    jmono = JaxMonodepth(encoder="vgg", width_mult=0.0625)
    fcn_params = numpy_params(jfcn, np.zeros((1, 128, 256, 3), np.float32), seed=0)
    mono_params = numpy_params(jmono, np.zeros((2, 128, 256, 3), np.float32), seed=1)
    frame = scene_pool(1, 384, 768, seed=5)[0][0]
    jpipe = jpipeline.SemanticDepthPipeline(
        _tiny_cfg(jconfig, "exact"), fcn_params, mono_params, fcn=jfcn, mono=jmono)
    return dict(fcn=fcn_params, mono=mono_params, frame=frame,
                jax_staged=jpipe.process_frame_staged(frame, disparity_mult=_MULT))


def _port(tiny, stat_mode, approach="both"):
    return tpipeline.SemanticDepthPipeline(
        _tiny_cfg(tconfig, stat_mode, approach),
        load_flax(FCN8s(num_classes=3, width_mult=0.0625, fc_channels=32), tiny["fcn"]),
        load_flax(Monodepth("vgg", width_mult=0.0625), tiny["mono"]),
        device="cpu",
    )


def _assert_outputs_equal(got, want):
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, pcl.MaskedCloud):
            for name in ("xyz", "rgb", "valid"):
                assert torch.equal(getattr(a, name), getattr(b, name)), f"road_cloud.{name}"
        else:
            assert a.shape == b.shape and torch.equal(a.isnan(), b.isnan()), f.name
            assert torch.equal(a.nan_to_num(), b.nan_to_num()), f.name


@pytest.mark.parametrize("stat_mode", ["grid", "exact"])
def test_process_frame_staged_equals_process_frame(tiny, stat_mode):
    pipe = _port(tiny, stat_mode)
    fused = pipe.process_frame(tiny["frame"], disparity_mult=_MULT)
    staged, times = pipe.process_frame_staged(tiny["frame"], disparity_mult=_MULT)
    assert int(fused.road_cloud.valid.sum()) > 200  # the road filters had work
    _assert_outputs_equal(staged, fused)
    jax_out, jax_times = tiny["jax_staged"]
    assert set(times) == set(jax_times)
    assert all(t >= 0.0 for t in times.values())
    # against the JAX staged run: the same ~1e-3 relative agreement as the
    # fused program's (tests/test_torch_pipeline.py), nan where JAX has nan
    if stat_mode == "exact":
        for name in ("dist_rw", "dist_f2f"):
            np.testing.assert_allclose(float(getattr(staged, name)), float(getattr(jax_out, name)),
                                       rtol=1e-3, equal_nan=True)


def test_process_frame_staged_rw_only(tiny):
    pipe = _port(tiny, "exact", approach="rw")
    staged, times = pipe.process_frame_staged(tiny["frame"], disparity_mult=_MULT)
    assert times["fences"] == times["f2f"] == 0.0
    assert staged.dist_f2f.isnan() and staged.fence_left_plane.isnan().all()
    assert not staged.fence_right_valid.any()
    _assert_outputs_equal(staged, pipe.process_frame(tiny["frame"], disparity_mult=_MULT))


# --- PLY ---------------------------------------------------------------------


def _ply_cases():
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.normal(size=(200, 3)) * 20, [[0, 0, -1e9]]])
    cols = rng.integers(0, 256, size=(201, 3)).astype(float)
    return {
        "cloud": (pts, cols, None),
        "with_add": (pts[:50], cols[:50], (pts[50:], np.tile([255.0, 0.0, 0.0], (151, 1)))),
        "one_point": (pts[:1], cols[:1], None),
        "empty": (np.zeros((0, 3)), np.zeros((0, 3)), None),
    }


@pytest.mark.parametrize("case", ["cloud", "with_add", "one_point", "empty"])
def test_ply_writer_bytes_equal_the_jax_writer(tmp_path, case):
    pts, cols, extra = _ply_cases()[case]
    paths = []
    for mod, name in ((jply, "jax"), (tply, "port")):
        cloud = mod.PlyCloud(pts, cols, str(tmp_path / name))
        if extra is not None:
            cloud.add(*extra)
        paths.append(cloud.save())
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def test_ply_reader_matches_the_jax_reader(tmp_path):
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.normal(size=(200, 3)) * 1e3, rng.normal(size=(200, 3)) * 1e-4])
    cols = rng.integers(0, 256, size=(400, 3)).astype(float)
    files = [
        jply.PlyCloud(pts, cols, str(tmp_path / "cloud")).save(),
        jply.PlyCloud(pts[:2], cols[:2], str(tmp_path / "single")).save(),  # one row
        # colorless, with a face element after the vertices (its properties
        # must not widen the vertex rows)
        _write(tmp_path / "mesh.ply",
               "ply\nformat ascii 1.0\nelement vertex 3\n"
               "property float x\nproperty float y\nproperty float z\n"
               "element face 1\nproperty list uchar int vertex_indices\nend_header\n"
               "0 1 2\n3 4 5\n6 7 8\n3 0 1 2\n"),
    ]
    for path in files:
        got, want = tply.read_ply(path), jply.read_ply(path)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("text,match", [
    ("ply\nformat ascii 1.0\nelement edge 1\nproperty int a\nelement vertex 1\n"
     "property float x\nproperty float y\nproperty float z\nend_header\n1\n0 0 0\n", "not first"),
    ("ply\nformat binary_little_endian 1.0\nelement vertex 1\nend_header\n", "only ascii"),
    ("ply\nformat ascii 1.0\nelement vertex 1\n", "unterminated"),
    ("plx\n", "not a PLY"),
])
def test_ply_reader_rejects_what_the_jax_reader_rejects(tmp_path, text, match):
    path = _write(tmp_path / "bad.ply", text)
    for mod in (jply, tply):
        with pytest.raises(ValueError, match=match):
            mod.read_ply(path)


# --- outlier removal -----------------------------------------------------------


@pytest.mark.parametrize("save_outliers", [False, True])
def test_filter_ply_on_cpu_matches_jax(tmp_path, save_outliers):
    """tests/test_utils.py's noisy cloud: the port on the CPU writes the same
    bytes as the JAX entry point."""
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.normal(size=(400, 3)) * 0.3, [[50.0, 50.0, 50.0], [-60.0, 0.0, 0.0]]])
    src = tply.PlyCloud(pts, np.zeros_like(pts), str(tmp_path / "noisy")).save()
    kw = dict(nb_neighbors=5, std_ratio=2.0, nb_points=3, radius=1.0, save_outliers=save_outliers)
    want = joutlier.filter_ply(src, str(tmp_path / "jax.ply"), **kw)
    got = toutlier.filter_ply(src, str(tmp_path / "port.ply"), device="cpu", **kw)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    kept, _ = tply.read_ply(got)
    assert kept.shape[0] == (400 if save_outliers else 398)  # 399 of 401 kept, then the
    # writer's infinity filter drops the lowest point
    assert save_outliers or np.abs(kept).max() < 10  # the strays are gone


def test_outlier_removal_cli_runs_on_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs there (test_torch_cuda.py)")
    src = tply.PlyCloud(np.eye(3), np.zeros((3, 3)), str(tmp_path / "in")).save()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        toutlier.main([src, "--out", str(tmp_path / "out.ply")])
