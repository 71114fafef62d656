"""The exact kNN (K4) and the paths that run it, on the CPU: its plain
PyTorch version against the JAX package's XLA scan and its Pallas kernel
(interpret mode), the exact statistical filter, and the frame program's
geometry tail under ``road.stat_mode="exact"``. The CUDA kernel itself is
tested on the card by test_torch_cuda.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_depth_tpu import config as jconfig
from semantic_depth_tpu import pipeline as jpipeline
from semantic_depth_tpu.ops import neighbors as jneighbors
from semantic_depth_tpu.ops import pcl as jpcl
from semantic_depth_tpu.ops.pallas_exact_knn import knn_mean_distances_exact_pallas
from semantic_depth_tpu_torch import config as tconfig
from semantic_depth_tpu_torch import pipeline as tpipeline
from semantic_depth_tpu_torch.ops import exact_knn, neighbors, pcl
from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

import oracles as o

torch.set_num_threads(2)  # six xdist workers share the machine


def _cloud(n=300, capacity=512, seed=0):
    """tests/test_neighbors.py's cloud: a normal blob with a tight cluster
    and far garbage on the invalid rows."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[: n // 2] *= 0.1
    xyz = np.zeros((capacity, 3), np.float32)
    xyz[:n] = pts
    xyz[n:] = 50.0
    return xyz, np.arange(capacity) < n


def _plain(xyz, valid, k):
    return exact_knn.knn_mean_distances_exact_plain(
        torch.from_numpy(xyz), torch.from_numpy(valid), k).numpy()


def test_plain_matches_xla_scan_and_pallas_kernel():
    xyz, valid = _cloud()
    cloud = jpcl.MaskedCloud(xyz=xyz, rgb=np.zeros_like(xyz), valid=valid)
    xla = np.asarray(jneighbors.knn_mean_distances(cloud, 10, block_size=128))
    pallas = np.asarray(knn_mean_distances_exact_pallas(
        jnp.asarray(xyz), jnp.asarray(valid), 10, tq=128, cb=128))
    got = _plain(xyz, valid, 10)
    fin = np.isfinite(xla)
    assert fin.sum() == 300
    for want in (xla, pallas):
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        # the same 10 distances; sums of their roots in another order
        np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-5)


@pytest.mark.parametrize("capacity", [1000, 2500])
def test_plain_takes_any_capacity_and_nan_garbage(capacity):
    """Capacities off the 1024-candidate block (a ragged last block) and nan
    on the invalid rows, against the brute-force oracle."""
    rng = np.random.default_rng(capacity)
    n = capacity - 37
    xyz = (rng.normal(size=(capacity, 3)) * [2.0, 0.3, 5.0]).astype(np.float32)
    xyz[n:] = np.nan
    valid = np.arange(capacity) < n
    got = _plain(xyz, valid, 10)
    want = o.o_knn_mean_distances(xyz[:n].astype(np.float64), 10)
    np.testing.assert_allclose(got[:n], want, rtol=1e-4, atol=1e-5)
    assert np.isinf(got[n:]).all()


def test_plain_duplicates_and_fewer_than_k():
    """tests/test_neighbors.py's cases: coincident points count once each,
    and a cloud smaller than k averages over the points it has."""
    capacity = 256
    xyz = np.full((capacity, 3), 9.0, np.float32)
    xyz[:4] = 0.0  # four coincident points
    xyz[4] = [1.0, 0.0, 0.0]
    valid = np.zeros(capacity, bool)
    valid[:5] = True
    got = _plain(xyz, valid, 4)
    want = np.asarray(knn_mean_distances_exact_pallas(
        jnp.asarray(xyz), jnp.asarray(valid), 4, tq=128, cb=128))
    assert got[0] == 0.0  # itself and three duplicates
    np.testing.assert_allclose(got[4], 3.0 / 4.0, atol=1e-6)
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[5:]).all()

    valid2 = np.zeros(capacity, bool)
    valid2[:3] = True
    got2 = _plain(xyz, valid2, 4)
    np.testing.assert_allclose(got2[:3], o.o_knn_mean_distances(xyz[:3], 4), rtol=1e-6)
    np.testing.assert_array_equal(got2, np.asarray(knn_mean_distances_exact_pallas(
        jnp.asarray(xyz), jnp.asarray(valid2), 4, tq=128, cb=128)))
    assert np.isinf(got2[3:]).all()
    # no valid point at all: every row is +inf
    assert np.isinf(_plain(xyz, np.zeros(capacity, bool), 4)).all()


def test_batched_wrapper_on_cpu_is_the_plain_version():
    frames = [_cloud(seed=s) for s in (1, 2)]
    xyz = torch.from_numpy(np.stack([f[0] for f in frames]))
    valid = torch.from_numpy(np.stack([f[1] for f in frames]))
    before = exact_knn.knn_mean_distances_exact.launches
    got = exact_knn.knn_mean_distances_exact(xyz, valid, 10)
    assert exact_knn.knn_mean_distances_exact.launches == before  # no kernel on the CPU
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(), _plain(*frames[i], 10))


@pytest.mark.parametrize("seed,std_ratio", [(1, 0.5), (4, 2.0)])
def test_statistical_outlier_filter_matches_jax(seed, std_ratio):
    """Keep masks agree except on points whose mean distance lies within
    1e-5 relative of the threshold (float32 sums in another order)."""
    frames = [_cloud(seed=seed), _cloud(n=200, seed=seed + 1)]
    xyz = np.stack([f[0] for f in frames])
    valid = np.stack([f[1] for f in frames])
    got = neighbors.statistical_outlier_filter(
        pcl.MaskedCloud(torch.from_numpy(xyz), torch.zeros(xyz.shape), torch.from_numpy(valid)),
        10, std_ratio).valid.numpy()
    for i in range(2):
        cloud = jpcl.MaskedCloud(xyz=xyz[i], rgb=np.zeros_like(xyz[i]), valid=valid[i])
        want = np.asarray(jneighbors.statistical_outlier_filter(cloud, 10, std_ratio).valid)
        md = np.asarray(jneighbors.knn_mean_distances(cloud, 10)).astype(np.float64)
        n = valid[i].sum()
        pos = valid[i] & (md > 0)
        mu = md[pos].sum() / n
        thr = mu + std_ratio * np.sqrt(((md[pos] - mu) ** 2).sum() / (n - 1))
        assert 0 < want.sum() < n
        differ = got[i] != want
        assert np.all(np.abs(md[differ] - thr) <= 1e-5 * thr), np.flatnonzero(differ)


def test_exact_filter_moments_divide_by_the_full_count():
    """A point on >= k-1 duplicates has mean 0: it leaves the sums but stays
    in n (the grid filter's finite count would differ), and is removed."""
    rng = np.random.default_rng(11)
    pts = np.concatenate([rng.normal(size=(64, 3)).astype(np.float32) * 0.2,
                          np.tile(np.float32([[5.0, 5.0, 5.0]]), (6, 1))])
    cloud = pcl.MaskedCloud(torch.from_numpy(pts)[None], torch.zeros((1, 70, 3)),
                            torch.ones((1, 70), dtype=torch.bool))
    got = neighbors.statistical_outlier_filter(cloud, 4, 2.0).valid[0].numpy()
    want = np.asarray(jneighbors.statistical_outlier_filter(
        jpcl.MaskedCloud(xyz=pts, rgb=pts, valid=np.ones(70, bool)), 4, 2.0).valid)
    assert not got[64:].any()
    np.testing.assert_array_equal(got, want)


def _exact_cfg(config_mod):
    # a 0.5 m slab: at 64x128 the default 5 cm slab holds no pixel row
    base = config_mod.munich_pipeline_config(input_height=64, input_width=128)
    return dataclasses.replace(
        base, rw_slab_halfwidth=0.5,
        road=dataclasses.replace(base.road, stat_mode="exact", neighbor_capacity=1024))


def test_exact_mode_geometry_tail_matches_jax():
    """The geometry tail under stat_mode='exact' on two analytic 64x128
    scenes (true masks and disparity) against the JAX vmapped tail."""
    h, w = 64, 128
    imgs, labels, disp_norm = scene_pool(2, h, w, seed=0)[:3]
    small = imgs.astype(np.float32)
    road, fence = labels == 7, labels == 13
    disp = (disp_norm * np.float32(2048.0 * w / 512.0)).astype(np.float32)

    jcfg = _exact_cfg(jconfig)
    jpipe = jpipeline.SemanticDepthPipeline.__new__(jpipeline.SemanticDepthPipeline)
    jpipe.config = jcfg  # the geometry tail reads only the config
    jcam, _ = jpipeline._scaled_camera(jcfg, jnp.float32(jcfg.camera.focal))
    want = jpipe._batch_geometry(
        jnp.asarray(small), jnp.asarray(road), jnp.asarray(fence), jnp.asarray(disp), jcam)

    tcfg = _exact_cfg(tconfig)
    tpipe = tpipeline.SemanticDepthPipeline.__new__(tpipeline.SemanticDepthPipeline)
    tpipe.config = tcfg
    tcam, _ = tpipeline._scaled_camera(tcfg, tcfg.camera.focal)
    before = exact_knn.knn_mean_distances_exact.launches
    with torch.inference_mode():
        got = tpipe._batch_geometry(
            torch.from_numpy(small), torch.from_numpy(road), torch.from_numpy(fence),
            torch.from_numpy(disp), tcam)
    assert exact_knn.knn_mean_distances_exact.launches == before

    assert got.road_cloud.valid.shape == (2, 1024)
    assert bool(got.rw_found.all())
    for f in ("dist_rw", "dist_f2f"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-4, equal_nan=True)
    same = got.road_cloud.valid.numpy() == np.asarray(want.road_cloud.valid)
    assert same.mean() >= 0.999
    # the exact filter ran: its cut differs from the grid mode's
    grid = tpipeline._denoise_road(
        pcl.from_dense(got.points3d, got.colors, torch.from_numpy(road)),
        dataclasses.replace(tcfg, road=dataclasses.replace(tcfg.road, stat_mode="grid")),
        (h, w))[0]
    assert not torch.equal(grid.valid, got.road_cloud.valid)
