"""The PyTorch port on a CUDA card: each hand-written kernel against its
plain version, the wrappers' argument checks, and the frame program on the
card against the CPU. Every test here needs a card (marker ``gpu``) and
skips without one. This file imports no JAX, so it also runs where only
the port's dependencies exist:

    python -m pytest tests/test_torch_cuda.py -q -m gpu --noconftest
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from semantic_depth_tpu_torch import camera, config, pipeline
from semantic_depth_tpu_torch.models import FCN8s, Monodepth
from semantic_depth_tpu_torch.io.ply import PlyCloud
from semantic_depth_tpu_torch.ops import _cuda, exact_knn, knn_grid, mad, radius
from semantic_depth_tpu_torch.utils import outlier_removal
from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool
from semantic_depth_tpu_torch.utils.probes import recording_kernel_calls, sync_debug

import torch_k4_schedule as k4

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_knn_grid_kernel_matches_plain(cuda):
    rng = np.random.default_rng(8)
    pts = (rng.normal(size=(2, 256, 512, 3)) * [2.0, 0.3, 5.0]).astype(np.float32)
    p = torch.from_numpy(pts).to(cuda)
    v = torch.from_numpy(rng.random((2, 256, 512)) < 0.4).to(cuda)
    got = knn_grid.knn_mean_distances_grid(p, v, 10, (5, 21))
    want = knn_grid.knn_mean_distances_grid_plain(p, v, 10, (5, 21))
    # same float32 operations in the same order (no FMA, IEEE sqrt/div) and
    # the same multiset of the 10 smallest: bit-equal, +inf pattern included
    assert torch.equal(got, want)


def test_knn_grid_kernel_bit_equal_with_valid_inf_points(cuda):
    """Zero disparity back-projects to +-inf (nan where a pixel sits on the
    principal point's row or column): blocks holding such a valid point
    take the kernel's exact path; a window of mostly nan distances gives
    nan, as torch.topk orders nan after +inf."""
    cfg = config.munich_pipeline_config()
    disp = torch.from_numpy(scene_pool(2, 256, 512, seed=1)[2] * np.float32(2048.0)).to(cuda)
    disp[0, 150:170, 100:300] = 0.0
    disp[1, 200:256, :] = 0.0
    pts = camera.reproject_disparity(disp, cfg.camera).contiguous()
    pts[1, 20:40, 30:90] = torch.tensor([float("inf"), float("inf"), float("-inf")], device=cuda)
    valid = torch.ones((2, 256, 512), dtype=torch.bool, device=cuda)
    valid[1, ::3] = False
    got = knn_grid.knn_mean_distances_grid(pts, valid, 10, (5, 21))
    want = knn_grid.knn_mean_distances_grid_plain(pts, valid, 10, (5, 21))
    assert torch.equal(got.isnan(), want.isnan()) and bool(want.isnan().any())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


def _k1_general_grids(cuda, h=64, w=160):
    """(4, h, w) grids: an analytic scene's road with 15% punched out, the
    same scene with zero-disparity patches (valid +-inf and nan points),
    random points 30% valid, and the scene all valid (full windows, for
    k = wh * ww)."""
    cfg = config.munich_pipeline_config(input_height=h, input_width=w)
    disp = torch.from_numpy(scene_pool(1, h, w, seed=2)[2] * np.float32(2048.0 * w / 512.0))
    labels = scene_pool(1, h, w, seed=2)[1]
    pts = camera.reproject_disparity(disp, cfg.camera)[0]
    rng = np.random.default_rng(9)
    road = torch.from_numpy((labels[0] == 7) & (rng.random((h, w)) >= 0.15))
    zero = disp.clone()
    zero[0, 5:12, 10:40] = 0.0
    inf_pts = camera.reproject_disparity(zero, cfg.camera)[0]
    inf_valid = torch.ones((h, w), dtype=torch.bool)
    inf_valid[::3, 1::4] = False
    rnd = torch.from_numpy((rng.normal(size=(h, w, 3)) * [2.0, 0.3, 5.0]).astype(np.float32))
    rnd_valid = torch.from_numpy(rng.random((h, w)) < 0.3)
    full = torch.ones((h, w), dtype=torch.bool)
    return (torch.stack([pts, inf_pts, rnd, pts]).contiguous().to(cuda),
            torch.stack([road, inf_valid, rnd_valid, full]).contiguous().to(cuda))


@pytest.mark.parametrize("k, window", [(20, (5, 21)), (10, (7, 21)), (10, (5, 31)),
                                       (10, (7, 31)), (6, (4, 20)), (40, (9, 33)), (64, (9, 9)),
                                       (1, (1, 1)), (3, (2, 2)), (33, (5, 11)), (32, (7, 31)),
                                       (33, (7, 31)), (64, (7, 31)), (217, (7, 31)), (81, (9, 9)),
                                       (8, (4, 2))])
def test_knn_grid_general_kernel_bit_equal(cuda, k, window):
    """Every (k, window) but the road chain's takes the general kernel
    (registers up to k = 32, shared memory above, k = wh * ww too; odd and
    even windows); bit-equal to the plain version, nan and +inf patterns
    included."""
    pts, valid = _k1_general_grids(cuda)
    before = _cuda.launches.copy()
    got = knn_grid.knn_mean_distances_grid(pts, valid, k, window)
    assert _since(before) == collections.Counter({"knn_grid": 1, "knn_grid.general": 1})
    want = knn_grid.knn_mean_distances_grid_plain(pts, valid, k, window)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert bool(torch.isfinite(want[valid]).any())


@pytest.mark.parametrize("k, window", [(10, (5, 21)), (20, (7, 31)), (40, (5, 11))])
def test_knn_grid_past_65535_frames_in_chunks(cuda, k, window):
    """65,537 small frames go in two launches (frames past 65,535 in the
    second), the specialised kernel's and the general kernel's alike,
    bit-equal to the plain version."""
    rng = np.random.default_rng(k)
    pts = torch.from_numpy((rng.normal(size=(65537, 8, 16, 3)) * [2.0, 0.3, 5.0])
                           .astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.random((65537, 8, 16)) < 0.9).to(cuda)
    before = _cuda.launches.copy()
    got = knn_grid.knn_mean_distances_grid(pts, valid, k, window)
    specialised = (k, window) == (knn_grid.KERNEL_K, knn_grid.KERNEL_WINDOW)
    assert _since(before) == collections.Counter(
        {"knn_grid": 2, "knn_grid.general": 2 * (not specialised)})
    want = knn_grid.knn_mean_distances_grid_plain(pts, valid, k, window)
    assert torch.equal(got, want) and bool(torch.isfinite(want[-1][valid[-1]]).any())


def test_knn_grid_road_chain_setting_keeps_the_specialised_kernel(cuda):
    pts, valid = _k1_general_grids(cuda)
    general = _cuda.launches["knn_grid.general"]
    got = knn_grid.knn_mean_distances_grid(pts, valid, knn_grid.KERNEL_K, knn_grid.KERNEL_WINDOW)
    assert _cuda.launches["knn_grid.general"] == general
    assert _equal_nan(got, knn_grid.knn_mean_distances_grid_plain(
        pts, valid, knn_grid.KERNEL_K, knn_grid.KERNEL_WINDOW))


def test_mad_kernel_matches_plain_bit_equal(cuda):
    rng = np.random.default_rng(2)
    n = 131072
    x = (rng.normal(size=n) * 7 - 2).astype(np.float32)
    with_inf = x.copy()
    with_inf[:30], with_inf[30:50] = np.inf, -np.inf
    rows = [
        (x, rng.random(n) < 0.6),
        (np.round(x), rng.random(n) < 0.6),  # heavy duplicates
        (np.full(n, 3.25, np.float32), rng.random(n) < 0.5),  # MAD = 0
        (x, np.zeros(n, bool)),  # empty
        (with_inf, rng.random(n) < 0.7),
        (x, rng.random(n) < 0.0001),  # a handful of points
    ]
    vals = torch.from_numpy(np.stack([r[0] for r in rows])).to(cuda)
    valid = torch.from_numpy(np.stack([r[1] for r in rows])).to(cuda)
    thr = torch.tensor([2.0, 2.0, 2.0, 2.0, 5.0, 15.0], device=cuda)
    assert torch.equal(mad.mad_keep_mask(vals, valid, thr), mad.mad_keep_mask_plain(vals, valid, thr))


def test_radius_kernel_matches_plain_bit_equal(cuda):
    rng = np.random.default_rng(9)
    b, c = 2, 1024
    pts = rng.normal(size=(b, c, 3)) * [0.8, 0.1, 1.5] + [0.0, -1.5, -10.0]
    pts[..., 2] = np.sort(pts[..., 2], axis=-1)  # compacted clouds keep image order
    xyz = torch.from_numpy(pts.astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.random((b, c)) < 0.9).to(cuda)
    w = torch.from_numpy(rng.choice([1.0, 2.0, 0.5], size=(b, c)).astype(np.float32)).to(cuda)
    want = radius.radius_counts_plain(xyz, valid, w, 0.5)
    assert torch.equal(radius.radius_counts(xyz, valid, w, 0.5), want)
    assert torch.equal(radius.radius_counts(xyz, valid, w, 0.5, skip=False), want)


def _radius_cloud(b, c, seed, weights="ones"):
    """(b, c) compacted-cloud-like frames, 85% valid, inf garbage on invalid
    rows; weights all ones, dyadic (1, 2, 0.5) or not (integers / 2.25)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, c, 3)) * [0.8, 0.1, 1.5] + [0.0, -1.5, -10.0]
    pts[..., 2] = np.sort(pts[..., 2], axis=-1)
    valid = rng.random((b, c)) < 0.85
    pts[~valid] = np.inf
    w = {"ones": np.ones((b, c)), "dyadic": rng.choice([1.0, 2.0, 0.5], size=(b, c)),
         "non_dyadic": rng.integers(1, 9, size=(b, c)) / 2.25}[weights]
    return (torch.from_numpy(pts.astype(np.float32)), torch.from_numpy(valid),
            torch.from_numpy(w.astype(np.float32)))


@pytest.mark.parametrize("weights", ["ones", "dyadic"])
@pytest.mark.parametrize("c", [1, 100, 1000, 16383])
def test_radius_kernel_bit_equal_at_any_capacity(cuda, c, weights):
    """A capacity off the kernel's 128-candidate tiles is padded with
    invalid, weight-0 rows and sliced back: bit-equal to the plain version,
    skip on and off, one launch a call."""
    xyz, v, w = (t.to(cuda) for t in _radius_cloud(2, c, seed=c, weights=weights))
    want = radius.radius_counts_plain(xyz, v, w, 0.5)
    before = _cuda.launches["radius"]
    got = radius.radius_counts(xyz, v, w, 0.5)
    assert _cuda.launches["radius"] == before + 1
    assert got.shape == (2, c) and got.is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(radius.radius_counts(xyz, v, w, 0.5, skip=False), want)
    if c >= 1000:
        assert float(want.max()) > 1.0  # the radius reaches neighbours


def test_radius_kernel_padded_non_dyadic_and_strided(cuda):
    """At capacity 1000 non-dyadic weights stay within the documented rtol
    1e-4 and equal over three runs; a non-contiguous view is copied into
    the kernel's layout and counts as its contiguous copy does."""
    xyz, v, w = (t.to(cuda) for t in _radius_cloud(3, 1000, seed=5, weights="non_dyadic"))
    runs = [radius.radius_counts(xyz, v, w, 0.5) for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])
    torch.testing.assert_close(runs[0], radius.radius_counts_plain(xyz, v, w, 0.5),
                               rtol=1e-4, atol=0)
    big, vb, wb = (t.to(cuda) for t in _radius_cloud(2, 1024, seed=6))
    got = radius.radius_counts(big[:, ::2], vb[:, ::2], wb[:, ::2], 0.5)
    assert torch.equal(got, radius.radius_counts_plain(big[:, ::2].contiguous(),
                                                       vb[:, ::2].contiguous(),
                                                       wb[:, ::2].contiguous(), 0.5))


def test_radius_kernel_past_65535_frames_in_chunks(cuda):
    xyz, v, w = (t.to(cuda) for t in _radius_cloud(65537, 4, seed=7))
    xyz = xyz * 0.05  # the four points of a frame lie within the radius
    before = _cuda.launches["radius"]
    got = radius.radius_counts(xyz, v, w, 0.5)
    assert _cuda.launches["radius"] == before + 2
    assert torch.equal(got, radius.radius_counts_plain(xyz, v, w, 0.5))


@pytest.mark.parametrize("n", [1, 3, 1022, 1025, (1 << 21) + 3])
def test_mad_kernel_bit_equal_at_any_row_length(cuda, n):
    """A row length off the kernel's 4-value vectors is padded with invalid
    entries and sliced back: bit-equal to the plain version, one launch a
    call. 2^21 + 3 values a row take the streamed mode."""
    rows = 2 if n > 1 << 20 else 8
    x, ok = _scene_like_rows(rows, n=n, seed=n % 1000)
    ok[1] = True
    vals = torch.from_numpy(x).to(cuda)
    valid = torch.from_numpy(ok).to(cuda)
    thr = mad.threshold_rows((5.0, 1.0), rows, cuda)
    want = mad.mad_keep_mask_plain(vals, valid, thr)
    before = _cuda.launches["mad"]
    got = mad.mad_keep_mask(vals, valid, (5.0, 1.0))
    assert _cuda.launches["mad"] == before + 1
    assert got.shape == (rows, n) and got.is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(mad.mad_keep_mask(vals, valid, thr), want)


def test_mad_kernel_misaligned_view_and_65537_rows(cuda):
    """A view 4 bytes into its storage is copied to an aligned tensor; 65538
    and 65537 rows of 4 go in two launches (rows past 65535 in the second),
    the threshold pair's second half spanning both."""
    x, ok = _scene_like_rows(2, n=1028, seed=8)
    vals = torch.from_numpy(x).to(cuda).reshape(-1)[1:2049].reshape(2, 1024)
    valid = torch.from_numpy(ok).to(cuda).reshape(-1)[1:2049].reshape(2, 1024)
    assert vals.data_ptr() % 16 and valid.data_ptr() % 4
    want = mad.mad_keep_mask_plain(vals, valid, torch.full((2,), 2.0, device=cuda))
    assert torch.equal(mad.mad_keep_mask(vals, valid, 2.0), want)
    rng = np.random.default_rng(10)
    rows = 65537 + 1
    vals = torch.from_numpy(rng.normal(size=(rows, 4)).astype(np.float32)).to(cuda)
    vals[:, 3] = 30.0  # one far value a row
    valid = torch.from_numpy(rng.random((rows, 4)) < 0.9).to(cuda)
    want = mad.mad_keep_mask_plain(vals, valid, mad.threshold_rows((5.0, 1.0), rows, cuda))
    before = _cuda.launches["mad"]
    got = mad.mad_keep_mask(vals, valid, (5.0, 1.0))
    assert _cuda.launches["mad"] == before + 2
    assert torch.equal(got, want)
    want = mad.mad_keep_mask_plain(vals[:65537], valid[:65537],
                                   torch.full((65537,), 2.0, device=cuda))
    assert torch.equal(mad.mad_keep_mask(vals[:65537], valid[:65537], 2.0), want)


def _scene_like_rows(rows, n=131072, seed=3):
    """Rows like the frame program's MAD planes: a coordinate around -1.5
    with a few far outliers, 7% (road) or 30% (fence) of the points valid."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, n)) * 0.2 - 1.5).astype(np.float32)
    out = rng.random((rows, n)) < 0.01
    x[out] = rng.uniform(-40, 40, size=int(out.sum()))
    frac = np.where(np.arange(rows) % 2 == 0, 0.07, 0.3)[:, None]
    return x, rng.random((rows, n)) < frac


@pytest.mark.parametrize("rows, thresholds", [(8, 15.0), (16, (5.0, 1.0))])
def test_mad_kernel_bit_equal_at_the_main_path_launches(cuda, rows, thresholds):
    """8 and 16 rows of 131072 (the frame program's four launches), with
    the thresholds by value as pcl passes them and as an (R,) tensor."""
    x, ok = _scene_like_rows(rows)
    vals = torch.from_numpy(x).to(cuda)
    valid = torch.from_numpy(ok).to(cuda)
    thr = mad.threshold_rows(thresholds, rows, cuda)
    want = mad.mad_keep_mask_plain(vals, valid, thr)
    assert torch.equal(mad.mad_keep_mask(vals, valid, thresholds), want)
    assert torch.equal(mad.mad_keep_mask(vals, valid, thr), want)


def test_mad_kernel_streams_a_row_of_2_21(cuda):
    x, ok = _scene_like_rows(2, n=1 << 20, seed=4)
    vals = torch.from_numpy(x.reshape(1, -1)).to(cuda)
    valid = torch.from_numpy(ok.reshape(1, -1)).to(cuda)
    thr = torch.full((1,), 2.0, device=cuda)
    got = mad.mad_keep_mask(vals, valid, 2.0)  # too long for shared memory: streamed
    assert torch.equal(got, mad.mad_keep_mask_plain(vals, valid, thr))


def test_mad_kernel_valid_values_in_one_slice(cuda):
    """Every valid value in one CTA's slice of 16384 (the others have none),
    at the first, a middle and the last slice, odd and even counts."""
    n = 131072
    rng = np.random.default_rng(6)
    x = np.tile((rng.normal(size=n) * 3).astype(np.float32), (6, 1))
    ok = np.zeros((6, n), bool)
    for i, (start, count) in enumerate([(0, 101), (0, 100), (9 * 8192 + 5, 2000),
                                        (9 * 8192 + 5, 2001), (n - 40, 40), (n - 4, 1)]):
        ok[i, start:start + count] = True
    vals = torch.from_numpy(x).to(cuda)
    valid = torch.from_numpy(ok).to(cuda)
    want = mad.mad_keep_mask_plain(vals, valid, torch.full((6,), 2.0, device=cuda))
    assert torch.equal(mad.mad_keep_mask(vals, valid, 2.0), want)


def test_radius_kernel_dead_blocks_empty_frame_and_ranges(cuda):
    """(8, 16384) compacted-cloud-like frames whose valid rows fill only the
    first half (half the query blocks hold no valid query), one frame with
    no valid row, inf garbage on invalid rows; skip on and off; the
    preparation kernel's ranges equal subtile_ranges'."""
    rng = np.random.default_rng(11)
    b, c = 8, 16384
    pts = rng.normal(size=(b, c, 3)) * [1.5, 0.05, 4.0] + [0.0, -1.5, -12.0]
    pts[..., 2] = np.sort(pts[..., 2], axis=-1)[:, ::-1]
    pts = (np.round(pts * 256) / 256).astype(np.float32)
    valid = np.zeros((b, c), bool)
    valid[:, :c // 2] = rng.random((b, c // 2)) < 0.85
    valid[5] = False
    pts[~valid] = np.inf
    xyz = torch.from_numpy(pts).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    w = torch.from_numpy(rng.choice([1.0, 2.0, 0.5], size=(b, c)).astype(np.float32)).to(cuda)
    want = radius.radius_counts_plain(xyz, v, w, 0.5)
    assert torch.equal(radius.radius_counts(xyz, v, w, 0.5), want)
    assert torch.equal(radius.radius_counts(xyz, v, w, 0.5, skip=False), want)
    assert float(want[5].abs().sum()) == 0.0 and float(want[0].max()) > 1.0
    scratch = torch.empty(radius.scratch_words(b, c), device=cuda)
    out = torch.empty((b, c), device=cuda)
    radius._launch(xyz, v, w, 0.5, True, scratch, out)
    assert torch.equal(out, want)
    ranges = scratch[:b * 2 * (c // radius.SUBTILE)].view(b, 2, -1)
    assert torch.equal(ranges, radius.subtile_ranges(xyz, v, 0.5))


@pytest.mark.parametrize("c", [16384, 1152])
def test_radius_kernel_sums_non_dyadic_weights_the_same_every_run(cuda, c):
    """Density weights divided by a pixel scale of 2.25 (a 384x768 input)
    are not dyadic, so their float32 sums depend on the order of the adds:
    the kernel adds its candidate splits in a fixed order, so three runs
    agree bit for bit, and each is within rtol 1e-4 of the plain version's
    blockwise sums (float32 sums of up to a few thousand terms in another
    order). At c = 1152 the kernel takes 9 splits, not 16."""
    rng = np.random.default_rng(13)
    pts = rng.normal(size=(4, c, 3)) * [1.0, 0.05, 2.0] + [0.0, -1.5, -12.0]
    xyz = torch.from_numpy(pts.astype(np.float32)).to(cuda)
    v = torch.from_numpy(rng.random((4, c)) < 0.8).to(cuda)
    w = torch.from_numpy(rng.integers(1, 9, size=(4, c)).astype(np.float32)).to(cuda)
    w = w / torch.tensor(2.25, device=cuda)
    runs = [radius.radius_counts(xyz, v, w, 0.5) for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])
    torch.testing.assert_close(runs[0], radius.radius_counts_plain(xyz, v, w, 0.5),
                               rtol=1e-4, atol=0)


def test_geometry_tail_makes_no_host_sync_in_mad_and_radius(cuda):
    """The MAD and radius filters of the frame program run under
    torch.cuda.set_sync_debug_mode('error'): a host-to-device copy of a
    threshold or a radius there would raise."""
    imgs, labels, disp_norm = scene_pool(2, 256, 512, seed=0)[:3]
    args = [torch.from_numpy(a).to(cuda) for a in (
        imgs.astype(np.float32), labels == 7, labels == 13, disp_norm * np.float32(2048.0))]
    cfg = config.munich_pipeline_config()
    cam, _ = pipeline._scaled_camera(cfg, cfg.camera.focal)
    pipe = pipeline.SemanticDepthPipeline(
        cfg, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625), device=cuda)
    before = _cuda.launches.copy()
    with torch.inference_mode(), sync_debug("error"):
        out = pipe._batch_geometry(*args, cam)
    torch.cuda.synchronize()
    assert [_cuda.launches[op] - before[op] for op in ("mad", "radius")] == [4, 1]
    assert bool(torch.isfinite(out.dist_rw).all())


def test_host_syncs_count_what_sync_debug_warns(cuda):
    """One munich process_batch under ``sync_debug("warn")`` on
    ``process_batch``, the profiler and program tracing, its tail a replay:
    the synchronising runtime calls the profiler sees inside ``sd.call``
    (the benchmark's ``host_syncs``) are as many as the warnings, and none
    is inside the tail. Over a short window of eager tails (each call a
    new focal, so a key's first sight: a replay opens no kernel span), the
    kernel wrappers' spans hold at least 0.98 of K1-K3's device ms."""
    import itertools
    import types

    from portbench.harness import program
    from portbench.metrics import kernels_span_ms

    torch.manual_seed(0)
    pipe = pipeline.SemanticDepthPipeline(
        config.munich_pipeline_config(), FCN8s(width_mult=0.0625, fc_channels=32),
        Monodepth(width_mult=0.0625), device=cuda)
    frames = scene_pool(2, 1024, 2048, seed=3)[0]
    pipe.process_batch(frames)
    pipe.process_batch(frames)  # the capture
    replays = pipe.tail_graphs.counts["replays"]
    got = program.sync_sites(lambda: pipe.process_batch(frames))
    assert pipe.tail_graphs.counts["replays"] == replays + 1
    assert len(got["spans"]) == len(got["sites"]) > 0, got
    assert not set(got["spans"]) & program.TAIL, got
    focals = itertools.count(400.0, 0.125)  # none the default 380: each a new key
    bench = types.SimpleNamespace(device=cuda, batches=[frames], batch=len(frames),
                                  call=lambda f: pipe.process_batch(f, focal=next(focals)))
    before = dict(pipe.tail_graphs.counts)
    t = dict(program=program.window(bench, 0.5))
    after = pipe.tail_graphs.counts
    assert after["eager"] > before["eager"]
    assert (after["captures"], after["replays"]) == (before["captures"], before["replays"])
    k = t["program"]["kernel_ms"]
    assert set(k) == {"K1", "K2", "K3"}
    assert kernels_span_ms.read(t) >= 0.98 * sum(k.values()) / t["program"]["frames"]


def _tail_inputs(b, h, w, seed, cuda):
    """small, road, fence, disp of ``b`` analytic scenes at h x w."""
    imgs, labels, disp_norm = scene_pool(b, h, w, seed=seed)[:3]
    return [torch.from_numpy(a).to(cuda) for a in (
        imgs.astype(np.float32), labels == 7, labels == 13,
        disp_norm * np.float32(2048.0 * w / 512.0))]


def _tail_pipe(cfg, cuda):
    # the geometry tail does not touch the networks: tiny ones will do
    return pipeline.SemanticDepthPipeline(
        cfg, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625), device=cuda)


def _bits_equal(a, b) -> bool:
    """Field by field, every bit (nan payloads included)."""
    return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(
        x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(a.leaves(), b.leaves()))


def _graph_counts(pipe):
    return dict(pipe.tail_graphs.counts)


@pytest.mark.parametrize("b, h, w, changes, launches", [
    (1, 256, 512, {}, [1, 4, 1, 0]),
    (8, 256, 512, {}, [1, 4, 1, 0]),
    (2, 1024, 2048, {}, [1, 4, 1, 0]),
    (8, 256, 512, dict(road=dict(stat_mode="exact")), [0, 4, 1, 1]),
    (8, 256, 512, dict(rw_estimator="plane_edge"), [1, 4, 1, 0]),
], ids=["frame1", "batch8", "native", "exact", "plane_edge"])
def test_replayed_tail_is_bit_equal_to_the_eager_body(cuda, b, h, w, changes, launches):
    """At the frame1 shape, batch 8, a native batch, and batch 8 in exact
    mode (K4) and with the plane-edge width: the first call of a key runs
    eagerly, the second captures, the rest replay, each call's FrameOutputs
    bit-equal to the eager body's field by field. A replay's fields are its
    own (cloned out of the graph's pool): call N's are the same after two
    calls on other inputs at the key, and the caller's inputs come back as
    given. The kernel wrappers' launches rise at each replay as at an eager
    call."""
    cfg = config.munich_pipeline_config(input_height=h, input_width=w)
    if "road" in changes:
        changes = dict(changes, road=dataclasses.replace(cfg.road, **changes["road"]))
    cfg = dataclasses.replace(cfg, **changes)
    cam, _ = pipeline._scaled_camera(cfg, pipeline._scalar(cfg.camera.focal))
    pipe = _tail_pipe(cfg, cuda)
    scenes = [_tail_inputs(b, h, w, seed, cuda) for seed in (11, 12)]
    with torch.inference_mode():
        want = [pipe._tail_body(*args, cam) for args in scenes]
        before = _graph_counts(pipe)
        outs = []
        for i in range(4):
            before_i = _launches()
            outs.append(pipe._batch_geometry(*scenes[i % 2], cam))
            torch.cuda.synchronize()
            assert [a - n for a, n in zip(_launches(), before_i)] == launches, i
        kept = outs[2].map(torch.clone)
        for _ in range(2):
            pipe._batch_geometry(*scenes[1], cam)
        torch.cuda.synchronize()
    after = _graph_counts(pipe)
    assert {k: after[k] - before[k] for k in after} == dict(eager=1, captures=1, replays=4)
    for i, out in enumerate(outs):
        assert _bits_equal(out, want[i % 2]), i
        small, road, fence, disp = scenes[i % 2]
        assert (out.frame_small is small and out.road_mask is road
                and out.fence_mask is fence and out.disparity is disp)
    assert _bits_equal(outs[2], kept)


def test_tail_graphs_count_over_a_window_of_calls(cuda):
    """n calls at one key: 1 eager, 1 capture, n - 2 replays. Calls with n
    distinct focals capture nothing. A replaced config captures anew."""
    cfg = config.munich_pipeline_config()
    pipe = _tail_pipe(cfg, cuda)
    args = _tail_inputs(2, 256, 512, 13, cuda)
    n = 7

    def calls(focals, config_=None):
        before = _graph_counts(pipe)
        if config_ is not None:
            pipe.config = config_
        with torch.inference_mode():
            for f in focals:
                cam, _ = pipeline._scaled_camera(pipe.config, pipeline._scalar(f))
                pipe._batch_geometry(*args, cam)
        torch.cuda.synchronize()
        after = _graph_counts(pipe)
        return {k: after[k] - before[k] for k in after}

    assert calls([380.0] * n) == dict(eager=1, captures=1, replays=n - 2)
    assert calls([381.0 + i for i in range(n)]) == dict(eager=n, captures=0, replays=0)
    deeper = dataclasses.replace(cfg, depth=cfg.depth + 0.5)
    assert calls([380.0] * 3, deeper) == dict(eager=1, captures=1, replays=1)
    assert calls([380.0] * 2, cfg) == dict(eager=0, captures=0, replays=2)


def test_replayed_tail_makes_no_host_sync(cuda):
    """A replayed tail under ``sync_debug("error")``: no copy of a constant
    from the host, no read of the card (the profiler's side is in
    ``test_host_syncs_count_what_sync_debug_warns``)."""
    from semantic_depth_tpu_torch.utils import probes

    cfg = config.munich_pipeline_config()
    cam, _ = pipeline._scaled_camera(cfg, pipeline._scalar(cfg.camera.focal))
    pipe = _tail_pipe(cfg, cuda)
    args = _tail_inputs(8, 256, 512, 14, cuda)
    with torch.inference_mode():
        for _ in range(2):
            pipe._batch_geometry(*args, cam)
        replays = _graph_counts(pipe)["replays"]
        with probes.sync_debug("error", [(pipeline.SemanticDepthPipeline, "_batch_geometry")]):
            out = pipe._batch_geometry(*args, cam)
    assert _graph_counts(pipe)["replays"] == replays + 1
    assert bool(torch.isfinite(out.dist_rw).all())


# --- monodepth's CUDA graph (``_batch_disparity``) ---------------------------

def _mono_graph_counts(pipe):
    return dict(pipe.mono_graphs.counts)


def _mono_pipe(cuda, net="vgg", b=8):
    """A bfloat16 pipeline at a cell's widths: ``vgg`` and ``resnet50`` the
    munich flip batch at 256x512, ``native`` the s2d vgg at 1024x2048 with
    the flip off, ``scenes`` the stand-in ``SceneMono`` of ``b`` scenes."""
    from portbench.harness.standins import SceneFCN, SceneMono

    native = net == "native"
    cfg = config.munich_pipeline_config(
        compute_dtype="bfloat16", **(dict(input_height=1024, input_width=2048) if native else {}))
    cfg = dataclasses.replace(cfg, monodepth=dataclasses.replace(
        cfg.monodepth, encoder="resnet50" if net == "resnet50" else "vgg",
        flip_average=not native))
    fcn = FCN8s(width_mult=0.0625, fc_channels=32)
    if net == "scenes":
        _, labels, disp_norm = scene_pool(b, 256, 512, seed=5)[:3]
        fcn = SceneFCN(torch.from_numpy(labels))
        mono = SceneMono(torch.from_numpy(disp_norm), True)
    else:
        torch.manual_seed(1)
        with torch.device(cuda):
            mono = Monodepth(encoder=cfg.monodepth.encoder, compute_dtype=torch.bfloat16,
                             input_s2d=native)
    return pipeline.SemanticDepthPipeline(cfg, fcn, mono, device=cuda)


def _smalls(pipe, b, cuda, seeds=(21, 22)):
    h, w = pipe.config.input_height, pipe.config.input_width
    return [torch.rand((b, h, w, 3), generator=torch.Generator(cuda).manual_seed(s),
                       device=cuda) * 255.0 for s in seeds]


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("net, b", [
    ("vgg", 1), ("vgg", 8), ("resnet50", 8), ("native", 2), ("scenes", 8),
], ids=["frame1", "batch8", "resnet50", "native", "scenes"])
def test_replayed_monodepth_is_bit_equal_to_the_eager_body(cuda, net, b):
    """At the cells' shapes (the native s2d path at batch 2): the first call
    of a key runs eagerly, the second captures, the rest replay, each the
    eager body times its call's multiplier (a new one each call: not in the
    key) to the bit. Each result is the caller's own: read after every
    later call, none has changed."""
    pipe = _mono_pipe(cuda, net, b)
    smalls = _smalls(pipe, b, cuda)
    mults = [pipeline._scalar(250.0 + 0.25 * i) for i in range(5)]
    with torch.inference_mode():
        want = [pipe._mono_body(s) for s in smalls]
        before = _mono_graph_counts(pipe)
        outs = [pipe._batch_disparity(smalls[i % 2], m) for i, m in enumerate(mults)]
        torch.cuda.synchronize()
    after = _mono_graph_counts(pipe)
    assert {k: after[k] - before[k] for k in after} == dict(eager=1, captures=1, replays=3)
    for i, (out, m) in enumerate(zip(outs, mults)):
        assert _same_bits(out, want[i % 2] * m), i


def test_replayed_process_batch_makes_no_host_sync_in_monodepth(cuda):
    """A munich ``process_batch`` whose monodepth replays: nothing in
    ``_batch_disparity`` synchronises under ``sync_debug("error")``; the
    profiler sees three syncs in the call (the resize's two matrices, the
    upload), none under ``sd.monodepth``."""
    from portbench.harness import program

    torch.manual_seed(0)
    pipe = pipeline.SemanticDepthPipeline(
        config.munich_pipeline_config(), FCN8s(width_mult=0.0625, fc_channels=32),
        Monodepth(width_mult=0.0625), device=cuda)
    frames = scene_pool(2, 1024, 2048, seed=3)[0]
    for _ in range(2):
        pipe.process_batch(frames)
    replays = _mono_graph_counts(pipe)["replays"]
    with sync_debug("error", [(pipeline.SemanticDepthPipeline, "_batch_disparity")]):
        out = pipe.process_batch(frames)
    assert _mono_graph_counts(pipe)["replays"] == replays + 1
    assert bool(torch.isfinite(out.disparity).all())
    got = program.sync_sites(lambda: pipe.process_batch(frames))
    assert len(got["spans"]) == len(got["sites"]) == 3, got
    assert "sd.monodepth" not in got["spans"], got


def test_weights_loaded_in_place_reach_the_next_replay(cuda):
    pipe = _mono_pipe(cuda, "vgg", 1)
    small, mult = _smalls(pipe, 1, cuda)[0], pipeline._scalar(250.0)
    with torch.inference_mode():
        first = [pipe._batch_disparity(small, mult) for _ in range(3)][-1]
    torch.manual_seed(5)
    with torch.device(cuda):
        other = Monodepth(compute_dtype=torch.bfloat16)
    pipe.mono.load_state_dict(other.state_dict())
    before = _mono_graph_counts(pipe)
    with torch.inference_mode():
        got = pipe._batch_disparity(small, mult)
        want = pipe._mono_body(small) * mult
    after = _mono_graph_counts(pipe)
    assert {k: after[k] - before[k] for k in after} == dict(eager=0, captures=0, replays=1)
    assert _same_bits(got, want) and not torch.equal(got, first)


def test_disparity_of_one_frame_is_the_callers_own_tensor(cuda):
    """``disparity()`` on one frame, replayed: its result lies outside the
    graph's pool and stays as it was after later replays."""
    pipe = _mono_pipe(cuda, "vgg", 1)
    frames = [s[0] for s in _smalls(pipe, 1, cuda)]
    outs = [pipe.disparity(frames[i % 2], 2048.0) for i in range(4)]
    kept = [o.clone() for o in outs]
    pipe.disparity(frames[1], 2048.0)
    torch.cuda.synchronize()
    (graph,) = pipe.mono_graphs.graphs.values()
    pool = graph.outputs.untyped_storage().data_ptr()
    assert all(o.untyped_storage().data_ptr() != pool for o in outs)
    assert all(torch.equal(o, k) for o, k in zip(outs, kept))
    assert _same_bits(outs[0], outs[2]) and _same_bits(outs[1], outs[3])


def _exact_knn_frames(c=1000):
    """Frames of one (4, c) batch, c off the kernel's tiles: a road-like
    cloud with nan garbage on its invalid rows, coincident duplicates, fewer
    valid points than k, and no valid point at all."""
    rng = np.random.default_rng(10)
    xyz = (rng.normal(size=(4, c, 3)) * [2.0, 0.3, 5.0]).astype(np.float32)
    valid = np.zeros((4, c), bool)
    valid[0] = rng.random(c) < 0.8
    xyz[0, ~valid[0]] = np.nan
    valid[1, :300] = True
    xyz[1, :40] = xyz[1, 0]  # 40 coincident points
    xyz[1, 40:80:2] = xyz[1, 41:81:2]  # and pairs
    valid[2, [3, 500, 999]] = True  # 3 < k valid points
    return xyz, valid


@pytest.mark.parametrize("k", [4, 10])
def test_exact_knn_kernel_matches_plain_bit_equal(cuda, k):
    xyz, valid = _exact_knn_frames()
    x = torch.from_numpy(xyz).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    got = exact_knn.knn_mean_distances_exact(x, v, k)
    want = exact_knn.knn_mean_distances_exact_plain(x, v, k)
    assert torch.equal(got, want)  # the +inf pattern included
    assert torch.isinf(got[3]).all() and torch.isfinite(got[v]).all()
    # and the plain version on the CPU (IEEE sqrt and division for certain)
    assert torch.equal(got.cpu(), exact_knn.knn_mean_distances_exact_plain(x.cpu(), v.cpu(), k))


@pytest.mark.parametrize("k", [33, 50, 64, 100, 128, 256])
def test_exact_knn_large_k_bit_equal(cuda, k):
    """k > 32 takes the large-k kernels: bit-equal to the plain version with
    the box skip and deferral and without, on the edge frames (fewer valid
    points than k among them) and the exact mode's road clouds."""
    fn = exact_knn.knn_mean_distances_exact
    for xyz, valid in ((torch.from_numpy(a).to(cuda) for a in _exact_knn_frames()),
                       k4.road_clouds(4, 256, 512, 16384, cuda)):
        want = exact_knn.knn_mean_distances_exact_plain(xyz, valid, k)
        large = _cuda.launches["exact_knn.large_k"]
        assert torch.equal(fn(xyz, valid, k), want)
        assert torch.equal(fn(xyz, valid, k, skip=False), want)
        assert _cuda.launches["exact_knn.large_k"] == large + 2


def _scene_cloud(cuda):
    """(1, 131072): every point of an analytic 256x512 scene, 1% of the rows
    replaced by uniform outliers in a box around it."""
    cfg = config.munich_pipeline_config()
    disp = torch.from_numpy(scene_pool(1, 256, 512, seed=0)[2] * np.float32(2048.0)).to(cuda)
    pts = camera.reproject_disparity(disp, cfg.camera).reshape(1, -1, 3).clone()
    rng = np.random.default_rng(4)
    rows = torch.from_numpy(rng.permutation(pts.shape[1])[:pts.shape[1] // 100]).to(cuda)
    out = rng.uniform([-40, -10, -100], [40, 10, -4], size=(rows.numel(), 3)).astype(np.float32)
    pts[0, rows] = torch.from_numpy(out).to(cuda)
    return pts.contiguous(), torch.ones((1, pts.shape[1]), dtype=torch.bool, device=cuda)


def _far_cloud(cuda):
    """A 48x200 grid at cm spacing 150-250 m from the origin."""
    rng = np.random.default_rng(3)
    ys, xs = np.mgrid[:48, :200]
    grid = np.stack([xs * 0.01, rng.normal(size=(48, 200)) * 0.002, ys * 0.01], -1)
    xyz = (grid.reshape(1, -1, 3) + [120.0, -80.0, -150.0]).astype(np.float32)
    valid = rng.random((1, 48 * 200)) < 0.9
    return torch.from_numpy(xyz).to(cuda), torch.from_numpy(valid).to(cuda)


@pytest.mark.parametrize("cloud", ["road", "scene", "far", "edge"])
def test_exact_knn_skip_on_and_off_bit_equal(cuda, cloud):
    """K4 with its box skip and deferral (skip=1), scanning everything
    (skip=0) and the plain version agree bit for bit: the exact mode's road
    clouds, a whole scene cloud with outliers, a cloud far from the origin
    (where the margin decides), and the edge frames."""
    xyz, valid = {"road": lambda: k4.road_clouds(8, 256, 512, 16384, cuda),
                  "scene": lambda: _scene_cloud(cuda),
                  "far": lambda: _far_cloud(cuda),
                  "edge": lambda: tuple(torch.from_numpy(a).to(cuda) for a in _exact_knn_frames())
                  }[cloud]()
    want = exact_knn.knn_mean_distances_exact_plain(xyz, valid, 10)
    assert torch.equal(exact_knn.knn_mean_distances_exact(xyz, valid, 10), want)
    assert torch.equal(exact_knn.knn_mean_distances_exact(xyz, valid, 10, skip=False), want)


def test_exact_knn_boxes_and_counts_match_the_emulated_schedule(cuda):
    """The preparation kernel's boxes equal ``subtile_boxes``; the kernels'
    counts (pairs of both walks, subtiles loaded and tested, deferred
    queries) equal what ``torch_k4_schedule`` counts for the same clouds,
    and their result equals the emulation's."""
    xyz, valid = k4.road_clouds(device=cuda)
    xyz[1, ::97] = torch.tensor([30.0, 5.0, -60.0], device=cuda)  # outliers to defer
    b, c = valid.shape
    scratch = torch.empty(exact_knn.scratch_words(b, c, 10), device=cuda)
    out = torch.empty((b, c), device=cuda)
    exact_knn._launch(xyz, valid, 10, True, scratch, out)
    sub, grp = exact_knn.scratch_boxes(scratch, b, c)
    want_sub, want_grp = exact_knn.subtile_boxes(xyz, valid)
    assert torch.equal(sub, want_sub) and torch.equal(grp, want_grp)
    emulated, counts = k4.emulate(xyz.cpu(), valid.cpu(), 10)
    assert exact_knn.scratch_stats(scratch) == counts and counts["deferred"] > 0
    assert torch.equal(out.cpu(), emulated)


@pytest.mark.parametrize("k", [40, 50])
def test_exact_knn_large_k_counts_match_the_emulated_schedule(cuda, k):
    """The large-k kernels' counts (pairs of the near and the far walk,
    subtiles loaded and tested, deferred queries) equal what
    ``torch_k4_schedule`` counts, and their result the emulation's; with
    the buffers in shared memory and, under small shared-memory limits,
    fewer warps a block and the buffers in the scratch."""
    xyz, valid = k4.road_clouds(device=cuda)
    xyz[1, ::97] = torch.tensor([30.0, 5.0, -60.0], device=cuda)  # outliers to defer
    b, c = valid.shape
    emulated, counts = k4.emulate(xyz.cpu(), valid.cpu(), k)
    assert counts["deferred"] > 0 and counts["pairs_far"] > 0
    # 4 warps a block; at 12 KB two; at 8 KB the buffers in the scratch
    for limit in (exact_knn.SMEM_OPTIN_BYTES, 12 * 1024, 8 * 1024):
        assert exact_knn.large_k_layout(k, limit)[1] == (limit > 8 * 1024)
        scratch = torch.empty(exact_knn.scratch_words(b, c, k, limit), device=cuda)
        out = torch.empty((b, c), device=cuda)
        exact_knn._launch(xyz, valid, k, True, scratch, out, limit)
        assert exact_knn.scratch_stats(scratch) == counts
        assert torch.equal(out.cpu(), emulated)


@pytest.mark.parametrize("k", [10, 50])
def test_exact_knn_past_65535_frames_in_chunks(cuda, k):
    """65,537 small clouds (40 rows, some with fewer valid points than k) go
    in two launches, bit-equal to the plain version."""
    rng = np.random.default_rng(k)
    xyz = torch.from_numpy((rng.normal(size=(65537, 40, 3)) * [2.0, 0.3, 5.0])
                           .astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.random((65537, 40)) < 0.8).to(cuda)
    before = _cuda.launches.copy()
    got = exact_knn.knn_mean_distances_exact(xyz, valid, k)
    assert _since(before) == collections.Counter(
        {"exact_knn": 2, "exact_knn.large_k": 2 * (k > 32)})
    assert torch.equal(got, exact_knn.knn_mean_distances_exact_plain(xyz, valid, k))
    assert bool(torch.isfinite(got[-1][valid[-1]]).all())


def test_exact_knn_makes_no_host_sync(cuda):
    xyz, valid = k4.road_clouds(device=cuda)
    exact_knn.knn_mean_distances_exact(xyz, valid, 10)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = exact_knn.knn_mean_distances_exact(xyz, valid, 10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(out, exact_knn.knn_mean_distances_exact_plain(xyz, valid, 10))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    p = torch.zeros((1, 32, 64, 3), device=cuda)
    v = torch.ones((1, 32, 64), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        knn_grid.knn_mean_distances_grid(p.double(), v, 10)
    for k, window in ((0, (5, 21)), (106, (5, 21)), (10, (0, 21))):
        with pytest.raises(ValueError):  # k outside 1 .. wh * ww
            knn_grid.knn_mean_distances_grid(p, v, k, window)
    with pytest.raises(ValueError, match="shared memory"):  # no block's halo fits
        knn_grid.knn_mean_distances_grid(p, v, 10, (301, 301))
    with pytest.raises(ValueError):
        knn_grid.knn_mean_distances_grid(p.transpose(1, 2).contiguous().transpose(1, 2), v, 10)
    vals = torch.zeros((2, 1024), device=cuda)
    ok = torch.ones((2, 1024), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        mad.mad_keep_mask(vals, ok, torch.ones(3, device=cuda))
    with pytest.raises(ValueError):
        mad.mad_keep_mask(vals[:1], ok[:1], (5.0, 1.0))  # a pair needs two equal halves
    with pytest.raises(ValueError):
        mad.mad_keep_mask(vals.double(), ok, 2.0)
    with pytest.raises(ValueError):
        mad.mad_keep_mask(vals[0], ok[0], 2.0)
    with pytest.raises(ValueError):
        radius.radius_counts(torch.zeros((128, 3), device=cuda),
                             torch.ones((128,), dtype=torch.bool, device=cuda),
                             torch.ones((128,), device=cuda), 0.5)
    with pytest.raises(ValueError):
        radius.radius_counts(torch.zeros((1, 128, 3), device=cuda),
                             torch.ones((1, 128), dtype=torch.bool, device=cuda),
                             torch.ones((1, 128), dtype=torch.float64, device=cuda), 0.5)
    x = torch.zeros((1, 100, 3), device=cuda)
    ok = torch.ones((1, 100), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        exact_knn.knn_mean_distances_exact(x, ok, 0)
    # past the register walks' k = 32 the large-k walks compute
    assert torch.equal(exact_knn.knn_mean_distances_exact(x, ok, 33),
                       exact_knn.knn_mean_distances_exact_plain(x, ok, 33))
    with pytest.raises(ValueError):
        exact_knn.knn_mean_distances_exact(x.double(), ok, 10)
    with pytest.raises(ValueError):
        exact_knn.knn_mean_distances_exact(x, ok[:, :99], 10)


def test_frame_program_on_the_card_matches_the_cpu(cuda):
    """The geometry tail through the kernels against the plain CPU path on
    an analytic scene, and a tiny-network process_batch that launches each
    kernel once per batch (MAD four times)."""
    imgs, labels, disp_norm = scene_pool(2, 256, 512, seed=0)[:3]
    args = [torch.from_numpy(a) for a in (
        imgs.astype(np.float32), labels == 7, labels == 13, disp_norm * np.float32(2048.0))]
    cfg = config.munich_pipeline_config()
    cam, _ = pipeline._scaled_camera(cfg, cfg.camera.focal)
    outs = {}
    for dev in ("cpu", cuda):
        pipe = pipeline.SemanticDepthPipeline(
            cfg, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625),
            device=dev)
        with torch.inference_mode():
            outs[str(dev)] = pipe._batch_geometry(*[a.to(dev) for a in args], cam)
    cpu, gpu = outs["cpu"], outs[str(cuda)]
    for f in ("dist_rw", "dist_f2f"):
        np.testing.assert_allclose(getattr(gpu, f).cpu().numpy(), getattr(cpu, f).numpy(),
                                   rtol=0, atol=1e-3, equal_nan=True)

    tiny = config.munich_pipeline_config(
        input_height=128, input_width=256,
        road=dataclasses.replace(cfg.road, neighbor_capacity=2048))
    torch.manual_seed(0)
    pipe = pipeline.SemanticDepthPipeline(
        tiny, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625))
    _cuda.launches.clear()
    out = pipe.process_batch(scene_pool(2, 384, 768, seed=5)[0], disparity_mult=100.0)
    assert _launches() == [1, 4, 1, 0]
    assert out.disparity.device.type == "cuda" and out.disparity.shape == (2, 128, 256)


_OPS = ("knn_grid", "mad", "radius", "exact_knn")  # K1-K4's keys in ``_cuda.launches``


def _launches():
    """K1-K4's launches so far."""
    return [_cuda.launches[op] for op in _OPS]


def _since(before):
    """The launches counted since ``before`` (a copy of ``_cuda.launches``),
    by key."""
    return _cuda.launches - before


def test_exact_mode_on_the_card_matches_the_cpu(cuda):
    """stat_mode='exact': the geometry tail on the card against the CPU on
    analytic scenes; process_batch launches K1 0, K2 4, K3 1, K4 1 times;
    process_frame_staged equals process_frame (K2 five times: the fence
    chain's two x cuts go separately)."""
    imgs, labels, disp_norm = scene_pool(2, 256, 512, seed=0)[:3]
    args = [torch.from_numpy(a) for a in (
        imgs.astype(np.float32), labels == 7, labels == 13, disp_norm * np.float32(2048.0))]
    base = config.munich_pipeline_config()
    cfg = dataclasses.replace(base, road=dataclasses.replace(base.road, stat_mode="exact"))
    cam, _ = pipeline._scaled_camera(cfg, cfg.camera.focal)
    outs = {}
    for dev in ("cpu", cuda):
        pipe = pipeline.SemanticDepthPipeline(
            cfg, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625),
            device=dev)
        with torch.inference_mode():
            outs[str(dev)] = pipe._batch_geometry(*[a.to(dev) for a in args], cam)
    cpu, gpu = outs["cpu"], outs[str(cuda)]
    for f in ("dist_rw", "dist_f2f"):
        np.testing.assert_allclose(getattr(gpu, f).cpu().numpy(), getattr(cpu, f).numpy(),
                                   rtol=0, atol=1e-3, equal_nan=True)

    tiny = config.munich_pipeline_config(
        input_height=128, input_width=256,
        road=dataclasses.replace(cfg.road, neighbor_capacity=2048))
    torch.manual_seed(0)
    pipe = pipeline.SemanticDepthPipeline(
        tiny, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625))
    frames = scene_pool(2, 384, 768, seed=5)[0]
    _cuda.launches.clear()
    pipe.process_batch(frames, disparity_mult=300.0)
    assert _launches() == [0, 4, 1, 1]
    fused = pipe.process_frame(frames[0], disparity_mult=300.0)
    pipe.process_frame_staged(frames[0], disparity_mult=300.0)  # the warm-up run
    _cuda.launches.clear()
    staged, times = pipe.process_frame_staged(frames[0], disparity_mult=300.0)
    assert _launches() == [0, 5, 1, 1]
    assert set(times) == {"read", "semantic", "disparity", "to3D", "road", "rw", "fences", "f2f"}
    for name in ("dist_rw", "dist_f2f", "disparity", "road_plane"):
        a, b = getattr(staged, name), getattr(fused, name)
        assert a.device.type == "cuda" and torch.equal(a.nan_to_num(), b.nan_to_num()), name
    assert torch.equal(staged.road_cloud.valid, fused.road_cloud.valid)


def test_filter_ply_on_the_card_writes_what_the_cpu_writes(cuda, tmp_path):
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.normal(size=(3000, 3)) * 0.3, rng.uniform(-40, 40, size=(30, 3))])
    src = PlyCloud(pts, rng.integers(0, 256, size=(3030, 3)), str(tmp_path / "noisy")).save()
    kw = dict(nb_neighbors=10, std_ratio=0.5, nb_points=20, radius=0.3)
    before = _cuda.launches["exact_knn"]
    got = outlier_removal.filter_ply(src, str(tmp_path / "card.ply"), **kw)
    assert _cuda.launches["exact_knn"] == before + 1
    want = outlier_removal.filter_ply(src, str(tmp_path / "cpu.ply"), device="cpu", **kw)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def _equal_nan(a, b):
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())


def test_kernels_bit_equal_at_the_native_frame_program_launches(cuda):
    """The geometry tail of the native 1024x2048 frame program on two
    analytic scenes: K1 on (2, 1024, 2048), K2 on its four launches of
    2^21-point rows, K3 on the compacted clouds with weights divided by the
    pixel scale 16, each call bit-equal to its plain version (K3 on three
    runs)."""
    imgs, labels, disp_norm = scene_pool(2, 1024, 2048, seed=7)[:3]
    args = [torch.from_numpy(a).to(cuda) for a in (
        imgs.astype(np.float32), labels == 7, labels == 13, disp_norm * np.float32(8192.0))]
    cfg = config.munich_pipeline_config(input_height=1024, input_width=2048)
    cam, _ = pipeline._scaled_camera(cfg, cfg.camera.focal)
    pipe = pipeline.SemanticDepthPipeline(
        cfg, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625), device=cuda)
    with torch.inference_mode(), recording_kernel_calls() as calls:
        out = pipe._batch_geometry(*args, cam)
    assert bool(out.rw_found.all())
    (pts, valid, k, window), = calls["knn_grid"]
    assert pts.shape == (2, 1024, 2048, 3)
    assert _equal_nan(knn_grid.knn_mean_distances_grid(pts, valid, k, window),
                      knn_grid.knn_mean_distances_grid_plain(pts, valid, k, window))
    assert [tuple(a[0].shape) for a in calls["mad"]] == [(2, 1 << 21)] * 3 + [(4, 1 << 21)]
    for vals, ok, thr in calls["mad"]:
        want = mad.mad_keep_mask_plain(vals, ok, mad.threshold_rows(thr, vals.shape[0], cuda))
        assert torch.equal(mad.mad_keep_mask(vals, ok, thr), want)
    (xyz, v, w, r), = calls["radius"]
    assert xyz.shape == (2, 16384, 3) and bool((w[v] * 16 == torch.round(w[v] * 16)).all())
    runs = [radius.radius_counts(xyz, v, w, r) for _ in range(3)]
    assert all(torch.equal(x, runs[0]) for x in runs[1:])
    assert torch.equal(runs[0], radius.radius_counts_plain(xyz, v, w, r))


def test_single_frame_cli_on_the_card(tmp_path):
    """The single-frame entry point on its default device with tiny random
    networks: the artifact suite, through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CLIs run on the card by default)")
    import cv2

    from semantic_depth_tpu_torch.cli import semantic_depth

    frame = tmp_path / "scene.png"
    cv2.imwrite(str(frame), scene_pool(1, 384, 768, seed=5)[0][0])
    before = _launches()
    semantic_depth.main(["--input_frame", str(frame), "--semantic_model", "random",
                         "--monodepth_checkpoint", "random", "--dev_tiny", "--save_data",
                         "--results_dir", str(tmp_path / "results")])
    assert [a - b for a, b in zip(_launches(), before)] == [1, 4, 1, 0]
    out = tmp_path / "results" / "scene"
    for suffix in (".png", "_disp.png", "_raw.ply", "_pointCloud.npz", "_ROAD.ply", "_ALL.ply",
                   "_times.txt", "_distances.txt"):
        assert (out / f"scene_output{suffix}").exists(), suffix


def _card_against_cpu_step(make_trainer, model, batch, lr, cuda):
    """One train step from the same parameters on the CPU and on the card:
    the losses within rel 1e-4, the gradients within 1e-3 of their norm
    (all parameters together) and 1e-2 of it in each parameter, the
    post-step parameters within 1% of lr where |g| > 1e-4 of the model's
    largest (the rule of ``probes.train_step_agreement``)."""
    import copy

    from semantic_depth_tpu_torch.utils.probes import train_step_agreement

    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    card = make_trainer(copy.deepcopy(model), cuda)
    cpu = make_trainer(model, "cpu")
    got, want = card.train_batch(*batch), cpu.train_batch(*batch)
    for k in ("loss", "image_loss", "smooth_loss", "lr_loss"):
        if k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-4), k
    agree = train_step_agreement(cpu, card, before, lr)
    assert agree["grad_rel"] < 1e-3 and agree["grad_rel_param"] < 1e-2, agree
    assert agree["step_err_lr"] < 1e-2, agree
    assert agree["moved"] > 0.99, agree
    return got, want


def test_fcn_train_step_on_the_card_matches_the_cpu(cuda):
    from semantic_depth_tpu_torch.config import TrainConfig
    from semantic_depth_tpu_torch.train.trainer import FCNTrainer

    rng = np.random.default_rng(11)
    images = rng.uniform(0, 255, (2, 64, 128, 3)).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 64, 128))]
    cfg = TrainConfig(image_shape=(64, 128))
    model = FCN8s(dropout_keep_prob=1.0, width_mult=0.125, fc_channels=32,
                  generator=torch.Generator().manual_seed(0))
    got, want = _card_against_cpu_step(
        lambda m, d: FCNTrainer(cfg, model=m, device=d), model, (images, labels),
        cfg.learning_rate, cuda)
    assert np.abs(got["cm"] - want["cm"]).sum() / 2 <= max(1, 1e-3 * want["cm"].sum())


def test_monodepth_train_step_on_the_card_matches_the_cpu(cuda):
    from semantic_depth_tpu_torch.train.monodepth_trainer import (
        MonodepthTrainConfig, MonodepthTrainer)

    rng = np.random.default_rng(12)
    left = rng.uniform(0, 1, (2, 128, 256, 3)).astype(np.float32)
    cfg = MonodepthTrainConfig()
    model = Monodepth(width_mult=0.0625, generator=torch.Generator().manual_seed(0))
    _card_against_cpu_step(lambda m, d: MonodepthTrainer(cfg, model=m, device=d), model,
                           (left, np.roll(left, -4, axis=2)), cfg.learning_rate, cuda)


def test_ops_on_the_card_bit_equal_to_the_direct_launches(cuda):
    """Each dispatcher op (``torch.ops.sd_torch.*``) launches its kernel,
    counts the launch, and gives the bits of the direct launch."""
    rng = np.random.default_rng(11)
    pts = torch.from_numpy((rng.normal(size=(2, 64, 128, 3)) * 3).astype(np.float32)).to(cuda)
    grid_ok = torch.from_numpy(rng.random((2, 64, 128)) < 0.5).to(cuda)
    vals = torch.from_numpy(rng.normal(size=(4, 4096)).astype(np.float32)).to(cuda)
    rows_ok = torch.from_numpy(rng.random((4, 4096)) < 0.7).to(cuda)
    xyz = torch.from_numpy((rng.normal(size=(2, 2048, 3)) * 2).astype(np.float32)).to(cuda)
    ok = torch.from_numpy(rng.random((2, 2048)) < 0.6).to(cuda)
    w = ok.float()
    before = _launches()

    direct = torch.empty((2, 64, 128), device=cuda)
    _cuda.check(_cuda.library().sd_knn_grid(
        pts.data_ptr(), grid_ok.data_ptr(), direct.data_ptr(), 2, 64, 128, 10, 5, 21,
        _cuda.stream_ptr(pts)), "knn_grid")
    got = torch.ops.sd_torch.knn_grid(pts, grid_ok, 10, [5, 21])
    assert torch.equal(got.nan_to_num(), direct.nan_to_num())

    direct = torch.empty((4, 4096), dtype=torch.bool, device=cuda)
    mad._launch(vals, rows_ok, (2.0, 3.0), direct)
    assert torch.equal(torch.ops.sd_torch.mad_keep(vals, rows_ok, None, 2.0, 3.0, 2), direct)

    direct = torch.empty((2, 2048), device=cuda)
    radius._launch(xyz, ok, w, 0.5, True, torch.empty(radius.scratch_words(2, 2048),
                                                      device=cuda), direct)
    assert torch.equal(torch.ops.sd_torch.radius_counts(xyz, ok, w, 0.5, True), direct)

    direct = torch.empty((2, 2048), device=cuda)
    exact_knn._launch(xyz, ok, 10, True, torch.empty(exact_knn.scratch_words(2, 2048, 10),
                                                     device=cuda), direct)
    assert torch.equal(torch.ops.sd_torch.exact_knn(xyz, ok, 10, True), direct)
    assert [a - b for a, b in zip(_launches(), before)] == [1, 1, 1, 1]


def test_frozen_program_on_the_card_equals_the_live_pipeline(cuda, tmp_path):
    """A batched program exported on the card serves the live outputs bit
    for bit (deterministic cuDNN on both sides) and launches the kernels
    from inside the program."""
    from semantic_depth_tpu_torch import export
    from semantic_depth_tpu_torch.cli.common import build_pipeline

    cfg = config.munich_pipeline_config(input_height=128, input_width=256)
    pipe = build_pipeline(cfg, "random", "random", tiny=True, device=cuda)
    frames = torch.from_numpy(scene_pool(2, 192, 384, seed=4)[0]).to(cuda)
    path = export.export_pipeline(pipe, str(tmp_path / "p.pt2"), (2, 192, 384, 3),
                                  batched=True, scalars_only=False)
    call = export.load_pipeline(path)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        want = pipe.process_batch(frames)
        before = _launches()
        got = call(frames, cfg.camera.focal, 384.0)
        torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launches(), before)] == [1, 4, 1, 0]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        pairs = ([(a.xyz, b.xyz), (a.valid, b.valid)] if f.name == "road_cloud" else [(a, b)])
        for x, y in pairs:
            assert x.is_cuda and torch.equal(x.isnan(), y.isnan()), f.name
            assert torch.equal(x.nan_to_num(), y.nan_to_num()), f.name


def test_two_ranks_sharing_the_card_serve_dp_bit_equal(cuda):
    """Two gloo ranks on the one card (``parallel.launch.run_ranks``), dp=2:
    each rank's shard of the gathered outputs equals its single-process
    ``process_batch`` bit for bit, and both ranks hold the same outputs."""
    from semantic_depth_tpu_torch.parallel.launch import run_ranks

    import test_torch_parallel_ranks as cases

    frames = np.random.default_rng(4).integers(0, 256, (4, 256, 512, 3)).astype(np.uint8)
    ranks = run_ranks(cases.run_dp_on_card, 2, frames, timeout_s=300)
    assert all(r["backend"] == "gloo" for r in ranks)
    assert all(r["shard"] == r["ref"] for r in ranks)
    assert ranks[0]["digest"] == ranks[1]["digest"]


def test_two_ranks_sharing_the_card_train_fcn_like_one_process(cuda):
    """The sharded FCN-8s step (``parallel/train_step.py``) on two gloo
    ranks sharing the card, meshes (dp 1, tp 2) and (2, 1), width 0.25 with
    fc 128 at 32x64, batch 8, keep 0.5: both steps' losses within rel 1e-4
    of the single-process trainer's on the card (the JAX sharded test's
    tolerance; the dropout masks are the same draws), and the replicated
    parameters with their Adam moments bit-equal on both ranks."""
    from semantic_depth_tpu_torch.models.from_flax import flax_from_module
    from semantic_depth_tpu_torch.parallel.launch import run_ranks

    import test_torch_parallel_ranks as cases

    kw = dict(width_mult=0.25, fc_channels=128)
    rng = np.random.default_rng(0)
    spec = dict(lr=1e-3, hw=(32, 64), fcn_kw=kw,
                params=flax_from_module(FCN8s(num_classes=3,
                                              generator=torch.Generator().manual_seed(2), **kw)),
                images=rng.uniform(0, 255, (8, 32, 64, 3)).astype(np.float32),
                labels=np.eye(3, dtype=np.float32)[rng.integers(0, 3, (8, 32, 64))])
    ranks = run_ranks(cases.fcn_steps_on_card, 2, spec, timeout_s=300)
    assert ranks[0]["backend"] == "gloo"
    for mesh in ((1, 2), (2, 1)):
        for r in ranks:
            assert r[mesh]["losses"] == pytest.approx(ranks[0]["single"], rel=1e-4), mesh
        assert ranks[0][mesh]["digests"]["replicated"] == ranks[1][mesh]["digests"]["replicated"]
