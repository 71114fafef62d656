"""K1 and K4 outside the road chain's setting, on the CPU: the plain
versions (which CPU tensors take, and which the CUDA kernels equal bit for
bit on the card) against the JAX package at every (k, window) the general
K1 kernel and every k the large-k K4 kernel serve, and the frame program's
geometry tail under such a road config and under the plane-edge estimator.
The kernels themselves run on the card in test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_depth_tpu import config as jconfig
from semantic_depth_tpu import pipeline as jpipeline
from semantic_depth_tpu.ops import neighbors as jneighbors
from semantic_depth_tpu.ops import pallas_knn
from semantic_depth_tpu.ops import pcl as jpcl
from semantic_depth_tpu.ops.pallas_knn import _knn_tile_body, knn_mean_distances_grid_pallas
from semantic_depth_tpu_torch import config as tconfig
from semantic_depth_tpu_torch import graphs as tgraphs
from semantic_depth_tpu_torch import pipeline as tpipeline
from semantic_depth_tpu_torch.ops import _cuda, exact_knn, knn_grid
from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

torch.set_num_threads(2)  # six xdist workers share the machine


def _grid(h=48, w=96, seed=3):
    """Random points, 60% valid, with a block of coincident points."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(h, w, 3)) * [2.0, 0.3, 5.0]).astype(np.float32)
    pts[10:14, 20:40] = pts[10, 20]
    return pts, rng.random((h, w)) < 0.6


def _k1_plain(pts, valid, k, window):
    return knn_grid.knn_mean_distances_grid_plain(
        torch.from_numpy(pts), torch.from_numpy(valid), k, window).numpy()


@pytest.mark.parametrize("k, window", [(10, (5, 21)), (20, (7, 31)), (40, (9, 33)),
                                       (6, (4, 20)), (64, (9, 9))])
def test_k1_plain_matches_jax_at_other_windows(k, window):
    pts, valid = _grid()
    want = np.asarray(jneighbors.knn_mean_distances_grid(
        jnp.asarray(pts), jnp.asarray(valid), k, window))
    got = _k1_plain(pts, valid, k, window)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.sum() > 0
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-6, atol=0)


def test_k1_plain_matches_the_pallas_kernel_at_an_even_window():
    """knn_mean_distances_grid_pallas in interpret mode, as
    test_pallas_knn.py runs it, at k = 6 and a (4, 20) window."""
    pts, valid = _grid(32, 64, seed=4)
    want = np.asarray(knn_mean_distances_grid_pallas(
        jnp.asarray(pts), jnp.asarray(valid), 6, (4, 20), tile_h=16))
    got = _k1_plain(pts, valid, 6, (4, 20))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.sum() > 0
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-6, atol=0)


def test_k1_plain_matches_the_pallas_kernel_body_at_7_31(monkeypatch):
    """``knn_mean_distances_grid_pallas`` at k = 20 and a (7, 31) window on a
    grid of two row tiles: the wrapper's own padding and tiling run as they
    are, and each grid step's halo slab goes through the kernel's body
    (``_knn_tile_body``, which each of its three ``pallas_call`` sites runs)
    op by op under ``jax.disable_jit``, because the interpreter's compile of
    the whole call at this window takes minutes and tens of GB on the CPU."""
    calls = []

    def pallas_call_op_by_op(kernel, *, grid, **_):
        assert kernel.func is pallas_knn._knn_kernel  # the resident variant
        kw = kernel.keywords
        slab = kw["tile_h"] + kw["wh"] - 1

        def run(planes, vmask):
            calls.append(grid)
            return jnp.concatenate([
                _knn_tile_body(*planes[:, i * kw["tile_h"]:i * kw["tile_h"] + slab],
                               vmask[i * kw["tile_h"]:i * kw["tile_h"] + slab], **kw)
                for i in range(grid[0])])
        return run

    monkeypatch.setattr(pallas_knn.pl, "pallas_call", pallas_call_op_by_op)
    pts, valid = _grid(32, 64, seed=4)
    with jax.disable_jit():
        want = np.asarray(knn_mean_distances_grid_pallas(
            jnp.asarray(pts), jnp.asarray(valid), 20, (7, 31), tile_h=16))
    assert calls == [(2,)]
    got = _k1_plain(pts, valid, 20, (7, 31))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.sum() > 0
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-6, atol=0)


@pytest.mark.parametrize("k", [40, 100])
def test_k4_plain_matches_jax_at_large_k(k):
    """The exact kNN past the register walks' k = 32: a blob with a tight
    cluster (tests/test_neighbors.py's cloud), far garbage on the invalid
    rows, and a frame with fewer valid points than k."""
    rng = np.random.default_rng(k)
    cap = 512
    xyz = np.full((2, cap, 3), 50.0, np.float32)
    xyz[0, :300] = rng.normal(size=(300, 3))
    xyz[0, :150] *= 0.1
    xyz[1, :60] = rng.normal(size=(60, 3))
    valid = np.zeros((2, cap), bool)
    valid[0, :300] = True
    valid[1, :60] = True
    got = exact_knn.knn_mean_distances_exact_plain(
        torch.from_numpy(xyz), torch.from_numpy(valid), k).numpy()
    for f in range(2):
        cloud = jpcl.MaskedCloud(xyz=xyz[f], rgb=np.zeros_like(xyz[f]), valid=valid[f])
        want = np.asarray(jneighbors.knn_mean_distances(cloud, k, block_size=128))
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got[f]), fin)
        assert fin.sum() == valid[f].sum()
        np.testing.assert_allclose(got[f][fin], want[fin], rtol=1e-5, atol=0)


def _geometry(config_mod, pipeline_mod, scenes, convert, **kw):
    h, w = 64, 128
    base = config_mod.munich_pipeline_config(input_height=h, input_width=w)
    road_kw = {k: v for k, v in kw.items() if k.startswith("stat_")}
    top_kw = {k: v for k, v in kw.items() if not k.startswith("stat_")}
    # a 0.5 m slab: at 64x128 the default 5 cm slab holds no pixel row
    cfg = dataclasses.replace(base, rw_slab_halfwidth=0.5,
                              road=dataclasses.replace(base.road, **road_kw), **top_kw)
    pipe = pipeline_mod.SemanticDepthPipeline.__new__(pipeline_mod.SemanticDepthPipeline)
    pipe.config = cfg  # the geometry tail reads only the config (and the port's, its graphs)
    if pipeline_mod is tpipeline:
        pipe.tail_graphs = tgraphs.Cache()
    focal = cfg.camera.focal if convert is torch.from_numpy else jnp.float32(cfg.camera.focal)
    cam, _ = pipeline_mod._scaled_camera(cfg, focal)
    return pipe._batch_geometry(*[convert(a) for a in scenes], cam)


@pytest.mark.parametrize("kw", [dict(stat_window=(7, 31), stat_nb_neighbors=20),
                                dict(rw_estimator="plane_edge")],
                         ids=["window_7_31_k20", "plane_edge"])
def test_geometry_tail_matches_jax_under_other_road_configs(kw):
    """The frame program's geometry tail on three analytic 64x128 scenes
    (true masks and disparity) against JAX's: the road chain's statistical
    filter at a (7, 31) window with k = 20, and the plane-edge road-width
    estimator (``pipeline._rw_endpoints``' other branch)."""
    h, w = 64, 128
    imgs, labels, disp_norm = scene_pool(3, h, w, seed=0)[:3]
    scenes = (imgs.astype(np.float32), labels == 7, labels == 13,
              (disp_norm * np.float32(2048.0 * w / 512.0)).astype(np.float32))
    want = _geometry(jconfig, jpipeline, scenes, jnp.asarray, **kw)
    before = _cuda.launches.copy()
    with torch.inference_mode():
        got = _geometry(tconfig, tpipeline, scenes, torch.from_numpy, **kw)
    assert _cuda.launches == before  # the CPU takes the plain path
    np.testing.assert_array_equal(got.rw_found.numpy(), np.asarray(want.rw_found))
    assert bool(got.rw_found.any())
    for f in ("dist_rw", "dist_f2f"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-3, equal_nan=True)
