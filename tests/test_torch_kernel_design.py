"""The designs of the K1-K4 CUDA kernels, emulated in plain torch on the
CPU and held against the plain versions (and through them the JAX package):

* K2 (``csrc/mad.cu``) selects each median by an MSB-first radix select
  whose per-CTA histograms are merged across a thread-block cluster: the
  emulation cuts the row into the cluster's slices, histograms each slice's
  valid keys with the wrapper's digit widths, sums the histograms, finds
  the digit by the kernel's two-level search over 32-bin groups, and takes
  the upper middle value of an even count by the kernel's rule.
* K3 (``csrc/radius.cu``) skips, per warp of queries, every 32-candidate
  subtile whose widened z-range misses the warp's valid-query z-range: the
  emulation counts only the pairs the kernel scans.
* K4 (``csrc/exact_knn.cu``) walks each warp's near field first over
  subtile and group boxes and skips what the margin proves holds no
  neighbour, defers far queries to a second walk: ``torch_k4_schedule``
  repeats its decisions and its counts.
* K1 (``csrc/knn_grid.cu``) visits the window nearest first with an early
  reject, valid flags folded into the candidates (+inf if invalid), and an
  exact path for blocks with non-finite valid points.
* Past k = 32 (the general K1, K4's large-k walks) a thread keeps its 32
  smallest in registers and the rest unsorted in shared memory with their
  largest tracked (``csrc/kselect.cuh``); K4's large-k far walk merges a
  warp's pending candidates into its k smallest by rank after a bitonic
  sort: both emulated value by value against sorting and ``topk``.

The kernels themselves run on the card in test_torch_cuda.py."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from semantic_depth_tpu_torch import camera, config
from semantic_depth_tpu_torch.ops import exact_knn, knn_grid, mad, pcl, radius
from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool
from test_torch_kernels import _mad_rows

import torch_k4_schedule as k4


# --- K2: the cluster's radix select ------------------------------------------


def _cluster_median(values, valid, slices, digits=mad.DIGIT_BITS):
    """K2's selection schedule on one row: (N,) float32 values and bool
    validity, cut into ``slices`` CTA slices -> the median, as float32."""
    n_elems = values.shape[0]
    slice_len = (-(-n_elems // slices) + 3) // 4 * 4
    keys = [mad._ordered_key(values[i * slice_len:(i + 1) * slice_len])[
        valid[i * slice_len:(i + 1) * slice_len]] for i in range(slices)]
    n = sum(int(k.numel()) for k in keys)
    if n == 0:
        return torch.tensor(float("nan"))
    k = (n - 1) // 2
    prefix = mask = less = eq = 0
    shift = 32
    for bits in digits:
        shift -= bits
        dmask = (1 << bits) - 1
        merged = sum(torch.bincount((kk[(kk & mask) == prefix] >> shift) & dmask,
                                    minlength=1 << bits) for kk in keys)
        groups = merged.reshape(-1, mad.GROUP).sum(-1)
        g_incl = groups.cumsum(0)
        g = int((g_incl > k).nonzero()[0])
        incl = merged[g * mad.GROUP:(g + 1) * mad.GROUP].cumsum(0) + (g_incl[g] - groups[g])
        b = int((incl > k).nonzero()[0])
        digit = g * mad.GROUP + b
        before = int(incl[b] - merged[digit])
        k -= before
        less += before
        eq = int(merged[digit])
        prefix |= digit << shift
        mask |= dmask << shift
    u_hi = prefix
    if n % 2 == 0 and less + eq < n // 2 + 1:
        u_hi = min(int(kk[kk > prefix].min()) for kk in keys if bool((kk > prefix).any()))
    lo, hi = mad._from_key(torch.tensor([prefix, u_hi]))
    return 0.5 * (lo + hi)


def _check_row(values, valid, slices):
    """The emulated median and MAD of one row equal the plain version's."""
    v = torch.from_numpy(values)
    ok = torch.from_numpy(valid)
    n = ok.sum()[None]
    want_med = mad._median_rows(v[None], ok[None], n)[0]
    med = _cluster_median(v, ok, slices)
    assert torch.equal(med.isnan(), want_med.isnan())
    assert torch.equal(med.nan_to_num(), want_med.nan_to_num())
    diffs = (v - want_med).abs()
    want_mad = mad._median_rows(diffs[None], ok[None], n)[0]
    got_mad = _cluster_median(diffs, ok, slices)
    assert torch.equal(got_mad.isnan(), want_mad.isnan())
    assert torch.equal(got_mad.nan_to_num(), want_mad.nan_to_num())


def _edge_rows():
    """The eight rows of the K2 parity tests, a row with nan values and a
    row whose valid values all sit in one slice."""
    rows = [(v, ok) for v, ok, _ in _mad_rows()]
    rng = np.random.default_rng(12)
    x = (rng.normal(size=2048) * 3).astype(np.float32)
    with_nan = x.copy()
    with_nan[::97] = np.nan
    rows.append((with_nan, rng.random(2048) < 0.5))
    one_slice = np.zeros(2048, bool)
    one_slice[1030:1090] = True  # inside the 9th of 16 slices
    rows.append((x, one_slice))
    return rows


@pytest.mark.parametrize("slices", [8, 16])
@pytest.mark.parametrize("row", range(10))
def test_cluster_radix_select_matches_the_plain_median(row, slices):
    values, valid = _edge_rows()[row]
    _check_row(values, valid, slices)


@settings(max_examples=40, deadline=None, database=None)
@given(seed=st.integers(0, 2**32 - 1), quarter=st.integers(1, 160),
       slices=st.sampled_from([8, 16]), pool=st.sampled_from([0, 3, 50]),
       frac=st.sampled_from([0.0, 0.02, 0.5, 1.0]))
def test_cluster_radix_select_on_drawn_rows(seed, quarter, slices, pool, frac):
    """Rows of 4..640 values: continuous, or drawn from a pool of a few
    values (duplicates straddling the middle), with inf, -inf and nan."""
    rng = np.random.default_rng(seed)
    n = 4 * quarter
    if pool:
        values = rng.choice(rng.normal(size=pool) * 5, size=n)
    else:
        values = rng.normal(size=n) * 10 ** rng.uniform(-3, 3)
    values = values.astype(np.float32)
    special = rng.random(n)
    values[special < 0.01] = np.inf
    values[(special >= 0.01) & (special < 0.02)] = -np.inf
    values[(special >= 0.02) & (special < 0.025)] = np.nan
    _check_row(values, rng.random(n) < frac, slices)


def test_mad_thresholds_by_value_match_the_tensor_form():
    rows = _mad_rows()
    vals = torch.from_numpy(np.stack([r[0] for r in rows]))
    valid = torch.from_numpy(np.stack([r[1] for r in rows]))
    one = mad.mad_keep_mask(vals, valid, 2.0)
    assert torch.equal(one, mad.mad_keep_mask(vals, valid, torch.full((8,), 2.0)))
    pair = mad.mad_keep_mask(vals, valid, (5.0, 1.0))
    want = mad.mad_keep_mask(vals, valid, torch.tensor([5.0] * 4 + [1.0] * 4))
    assert torch.equal(pair, want)
    with pytest.raises(ValueError):
        mad.mad_keep_mask(vals[:7], valid[:7], (5.0, 1.0))  # no two equal halves


# --- K3: the per-warp subtile skip --------------------------------------------


def _counts_with_warp_skip(xyz, valid, weights, r):
    """radius_counts_plain's arithmetic over only the (warp, subtile) pairs
    that the kernel scans: a warp of WARP_QUERIES consecutive queries reads
    a subtile when the subtile's range (``subtile_ranges``) meets the
    z-range of the warp's valid queries (nan left out)."""
    b, c = valid.shape
    ranges = radius.subtile_ranges(xyz, valid, r)
    w = torch.where(valid, weights, 0.0)
    cands = torch.where(valid[..., None], xyz, 0.0)
    sq_c = (cands[..., 0] * cands[..., 0] + cands[..., 1] * cands[..., 1]
            + cands[..., 2] * cands[..., 2])
    out = torch.zeros((b, c))
    scanned = 0
    for f in range(b):
        for q0 in range(0, c, radius.WARP_QUERIES):
            qv = valid[f, q0:q0 + radius.WARP_QUERIES]
            q = xyz[f, q0:q0 + radius.WARP_QUERIES]
            ok = qv & ~q[:, 2].isnan()
            zmin = torch.where(ok, q[:, 2], float("inf")).amin()
            zmax = torch.where(ok, q[:, 2], float("-inf")).amax()
            subs = ((ranges[f, 0] <= zmax) & (ranges[f, 1] >= zmin)).nonzero()[:, 0]
            idx = (subs[:, None] * radius.SUBTILE + torch.arange(radius.SUBTILE)).reshape(-1)
            scanned += idx.numel() * int(qv.sum())
            cx, cy, cz = cands[f, idx].unbind(-1)
            qx, qy, qz = q.unbind(-1)
            sq_q = qx * qx + qy * qy + qz * qz
            cross = qx[:, None] * cx + qy[:, None] * cy + qz[:, None] * cz
            d2 = torch.clamp_min((sq_q[:, None] + sq_c[f, idx]) - 2.0 * cross, 0.0)
            acc = torch.where(d2 < float(r) ** 2, w[f, idx], 0.0).sum(-1)
            out[f, q0:q0 + radius.WARP_QUERIES] = torch.where(qv, acc, 0.0)
    return out, scanned


def _skip_clouds():
    """(4, 1024) frames: a road-like cloud in image (z) order with holes and
    inf garbage on its invalid rows; one whose valid rows start past the
    first tiles and carry a nan and an inf point; one with no valid row;
    a dense cluster where nothing can be skipped."""
    rng = np.random.default_rng(21)
    b, c = 4, 1024
    xyz = np.zeros((b, c, 3), np.float32)
    valid = np.zeros((b, c), bool)
    pts = rng.normal(size=(c, 3)) * [1.5, 0.05, 4.0] + [0.0, -1.5, -12.0]
    pts[:, 2] = np.sort(pts[:, 2])
    xyz[0] = pts
    valid[0, :700] = rng.random(700) < 0.8
    xyz[0, ~valid[0]] = np.inf
    xyz[1] = np.roll(pts, 300, axis=0)
    valid[1, 300:900] = rng.random(600) < 0.9
    valid[1, [400, 500]] = True
    xyz[1, 400, 2] = np.nan
    xyz[1, 500] = [0.0, 0.0, np.inf]
    xyz[2] = rng.normal(size=(c, 3))
    xyz[3] = rng.normal(size=(c, 3)) * 0.2
    valid[3] = rng.random(c) < 0.5
    weights = rng.choice([1.0, 2.0, 0.5, 3.0], size=(b, c)).astype(np.float32)
    return torch.from_numpy(xyz), torch.from_numpy(valid), torch.from_numpy(weights)


@pytest.mark.parametrize("r", [0.5, 0.05])
def test_warp_subtile_skip_never_drops_a_neighbour(r):
    xyz, valid, weights = _skip_clouds()
    want = radius.radius_counts_plain(xyz, valid, weights, r)
    got, scanned = _counts_with_warp_skip(xyz, valid, weights, r)
    assert torch.equal(got, want)
    assert want[0].max() > 1.0 and float(want[2].abs().sum()) == 0.0
    # the skip does skip: on the sorted road cloud most subtiles are left out
    road, road_scanned = _counts_with_warp_skip(xyz[:1], valid[:1], weights[:1], r)
    assert road_scanned < 0.5 * int(valid[0].sum()) * valid.shape[1]


def test_subtile_ranges_rule():
    xyz, valid, _ = _skip_clouds()
    ranges = radius.subtile_ranges(xyz, valid, 0.5)
    assert ranges.shape == (4, 2, 1024 // radius.SUBTILE) and ranges.dtype == torch.float32
    # no valid row: every subtile empty, (+inf, -inf)
    assert bool(torch.isposinf(ranges[2, 0]).all()) and bool(torch.isneginf(ranges[2, 1]).all())
    # a valid inf point: max|p|^2 = inf widens every non-empty range to everything
    assert bool(torch.isneginf(ranges[1, 0, 300 // 32 + 1:900 // 32]).all())
    # finite frames: the radius plus the float32 Gram error bound
    sq = (xyz[3] * xyz[3]).sum(-1)
    zthr = float(torch.sqrt(0.25 + 4e-6 * sq[valid[3]].max()))
    z = xyz[3, :32, 2][valid[3, :32]]
    assert float(ranges[3, 0, 0]) == pytest.approx(float(z.min()) - zthr, abs=1e-6)
    assert float(ranges[3, 1, 0]) == pytest.approx(float(z.max()) + zthr, abs=1e-6)


def test_pcl_mad_filters_pass_thresholds_by_value(monkeypatch):
    """The frame program's MAD calls hand the kernel floats, never a tensor
    (a tensor made from host floats is a synchronising copy on the card)."""
    seen = []
    real = mad.mad_keep_mask

    def spy(values, valid, thresholds):
        seen.append(thresholds)
        return real(values, valid, thresholds)

    monkeypatch.setattr(mad, "mad_keep_mask", spy)
    rng = np.random.default_rng(5)
    xyz = torch.from_numpy(rng.normal(size=(2, 256, 3)).astype(np.float32))
    cloud = pcl.MaskedCloud(xyz, xyz, torch.from_numpy(rng.random((2, 256)) < 0.7))
    pcl.mad_filter(cloud, 1, 15.0)
    pcl.mad_filter_pair(cloud, cloud, 0, 5.0, 1.0)
    assert seen == [15.0, (5.0, 1.0)]


def test_recorder_sees_the_frame_programs_own_launches():
    """``utils.probes.recording_kernel_calls`` (which the card's smoke run
    and timing tools replay) records the grid geometry tail's four MAD calls
    (road y and x, fence y, the fence pair), its one radius call and its one
    windowed kNN call, with the thresholds and the radius as plain numbers,
    and restores the wrappers afterwards."""
    from semantic_depth_tpu_torch import config, pipeline
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth
    from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool
    from semantic_depth_tpu_torch.utils.probes import recording_kernel_calls

    imgs, labels, disp_norm = scene_pool(2, 256, 512, seed=0)[:3]
    args = [torch.from_numpy(a) for a in (
        imgs.astype(np.float32), labels == 7, labels == 13, disp_norm * np.float32(2048.0))]
    cfg = config.munich_pipeline_config()
    cam, _ = pipeline._scaled_camera(cfg, cfg.camera.focal)
    pipe = pipeline.SemanticDepthPipeline(
        cfg, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625), device="cpu")
    wrappers = (mad.mad_keep_mask, radius.radius_counts)
    with torch.inference_mode():
        want = pipe._batch_geometry(*args, cam)
        with recording_kernel_calls() as calls:
            got = pipe._batch_geometry(*args, cam)
    assert (mad.mad_keep_mask, radius.radius_counts) == wrappers
    assert [(c[0].shape, c[2]) for c in calls["mad"]] == [
        ((2, 131072), 15.0), ((2, 131072), 2.0), ((2, 131072), 5.0), ((4, 131072), (5.0, 1.0))]
    (xyz, valid, weights, r), = calls["radius"]
    assert xyz.shape == (2, 16384, 3) and r == cfg.road.radius
    (points, ok, k, window), = calls["knn_grid"]
    assert points.shape == (2, 256, 512, 3) and (k, tuple(window)) == (10, (5, 21))
    assert calls["exact_knn"] == []  # grid mode
    assert torch.equal(got.dist_rw, want.dist_rw)


# --- K4: boxes, near-first walk, margin skip, deferral ------------------------


def _edge_frames(c=2500):
    """(4, c), a capacity off the subtiles: a road-like cloud in image order
    with nan on its invalid rows and a valid nan point, coincident
    duplicates, 4 < k valid points, none valid."""
    rng = np.random.default_rng(3)
    xyz = np.cumsum(rng.normal(size=(4, c, 3)) * [0.05, 0.01, 0.05], axis=1).astype(np.float32)
    valid = rng.random((4, c)) < 0.8
    xyz[0][~valid[0]] = np.nan
    xyz[0, 7, 1] = np.nan  # a valid row with a nan coordinate
    valid[0, 7] = True
    valid[1] = True
    xyz[1, :100] = xyz[1, 0]
    xyz[1, 100:400:2] = xyz[1, 101:401:2]
    valid[2] = False
    valid[2, [0, 777, 1500, c - 1]] = True
    valid[3] = False
    return torch.from_numpy(xyz), torch.from_numpy(valid)


def _outlier_frames(c=4096):
    """(2, c) image-ordered walks with 2% uniform outliers, one valid inf
    point and one nan coordinate: far queries to defer, inflated boxes."""
    rng = np.random.default_rng(4)
    xyz = np.cumsum(rng.normal(size=(2, c, 3)) * 0.05, axis=1)
    out = rng.random((2, c)) < 0.02
    xyz[out] = rng.uniform(-20, 20, size=(int(out.sum()), 3))
    xyz[1, 100] = [np.inf, 0.0, 0.0]
    xyz[1, 200, 1] = np.nan
    return torch.from_numpy(xyz.astype(np.float32)), torch.ones((2, c), dtype=torch.bool)


_K4_CASES = {
    "blob": lambda: tuple(torch.from_numpy(np.stack(a)) for a in zip(*[_blob(s) for s in (1, 2)])),
    "road": k4.road_clouds,
    "edge": _edge_frames,
    "outliers": _outlier_frames,
}


def _blob(seed):
    """test_torch_exact_knn.py's cloud: a normal blob with a tight cluster,
    far garbage on the invalid rows."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    pts[:150] *= 0.1
    xyz = np.full((512, 3), 50.0, np.float32)
    xyz[:300] = pts
    return xyz, np.arange(512) < 300


@pytest.mark.parametrize("case,k,skip", [
    ("blob", 10, True), ("road", 10, True), ("road", 10, False), ("edge", 10, True),
    ("edge", 4, True), ("edge", 10, False), ("outliers", 10, True), ("outliers", 1, True),
    ("outliers", 32, True)])
def test_k4_schedule_is_bit_equal_to_the_plain_version(case, k, skip):
    xyz, valid = _K4_CASES[case]()
    got, stats = k4.emulate(xyz, valid, k, skip)
    assert torch.equal(got, exact_knn.knn_mean_distances_exact_plain(xyz, valid, k))
    n = valid.sum(-1).double()
    if not skip:  # every candidate of every live warp
        assert stats["deferred"] == 0 and stats["subtile_tests"] == 0
        return
    if case == "road":  # the near walk scans a small share of the pairs
        assert stats["pairs_near"] < 0.25 * float((n * n).sum())
    if case == "outliers" and k == 10:  # outliers leave their warps
        assert stats["deferred"] > 0 and stats["pairs_far"] > 0


@settings(max_examples=12, deadline=None, database=None)
@given(seed=st.integers(0, 2**32 - 1), dist=st.floats(50.0, 200.0),
       spacing=st.sampled_from([0.005, 0.01, 0.02]))
def test_k4_schedule_far_from_the_origin(seed, dist, spacing):
    """Clouds |p| ~ 50-200 m out at cm spacing: the Gram identity's float32
    error is then far above the spacing, and the skip margin decides."""
    rng = np.random.default_rng(seed)
    h, w = 24, 64
    ys, xs = np.mgrid[:h, :w]
    grid = np.stack([xs * spacing, rng.normal(size=(h, w)) * spacing * 0.2, ys * spacing], -1)
    center = dist * rng.normal(size=3) / np.linalg.norm(rng.normal(size=3))
    xyz = torch.from_numpy((grid.reshape(1, -1, 3) + center).astype(np.float32))
    valid = torch.from_numpy(rng.random((1, h * w)) < 0.9)
    got, _ = k4.emulate(xyz, valid, 10)
    assert torch.equal(got, exact_knn.knn_mean_distances_exact_plain(xyz, valid, 10))


def test_subtile_boxes_against_numpy():
    """Boxes of a capacity off the subtiles (1100 rows: 35 subtiles, 2
    groups) with nan rows, an empty subtile, a subtile whose valid rows
    are all nan, and an inf point."""
    rng = np.random.default_rng(6)
    b, c = 2, 1100
    xyz = (rng.normal(size=(b, c, 3)) * [3.0, 0.5, 8.0]).astype(np.float32)
    valid = rng.random((b, c)) < 0.7
    xyz[0, 5, 2] = np.nan
    valid[0, 5] = True
    valid[0, 64:96] = False  # subtile 2 empty
    valid[1, 96:128] = True
    xyz[1, 96:128, 0] = np.nan  # subtile 3: every valid row nan
    xyz[1, 200] = [np.inf, 1.0, 1.0]
    valid[1, 200] = True
    sub, grp = exact_knn.subtile_boxes(torch.from_numpy(xyz), torch.from_numpy(valid))
    s = -(-c // 32)
    want = np.zeros((b, s, 8), np.float32)
    for f in range(b):
        for t in range(s):
            p = xyz[f, t * 32:(t + 1) * 32]
            ok = valid[f, t * 32:(t + 1) * 32] & ~np.isnan(p).any(-1)
            q = p[ok]
            if len(q):
                sq = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]) + q[:, 2] * q[:, 2]
                want[f, t] = [*q.min(0), sq.max(), *q.max(0), 0.0]
            else:
                want[f, t] = [np.inf] * 3 + [0.0] + [-np.inf] * 3 + [0.0]
    np.testing.assert_array_equal(sub.numpy(), want)
    assert np.isinf(want[1, 200 // 32, 3]) and want[0, 2, 0] == np.inf and want[1, 3, 0] == np.inf
    for g in range(2):
        part = want[:, g * 32:(g + 1) * 32]
        np.testing.assert_array_equal(grp[:, g, :3].numpy(), part[..., :3].min(1))
        np.testing.assert_array_equal(grp[:, g, 3].numpy(), part[..., 3].max(1))
        np.testing.assert_array_equal(grp[:, g, 4:7].numpy(), part[..., 4:7].max(1))


# --- K1: near-first order, early reject, folded valid flags -------------------

_K1_BLOCK = (16, 32)  # csrc/knn_grid.cu: pixel rows and columns of a block
# the general kernel's cases: odd and even windows, k in registers and above
_K1_GENERAL = [(20, (7, 31)), (6, (4, 20)), (40, (9, 33)), (3, (2, 2))]


def _k1_order(window=(5, 21), rows=2):
    """csrc/knn_grid.cu's ``Order``, written out: the union of a thread's two
    windows as (dy, dx) from its first pixel, nearest to the pixels'
    midpoint first (key (2 dy - 1)^2 + 4 dx^2, ties by dy, then dx)."""
    wh, ww = window
    offsets = [(dy, dx) for dy in range(-(wh // 2), wh - wh // 2 + rows - 1)
               for dx in range(-(ww // 2), ww - ww // 2)]
    return sorted(offsets, key=lambda o: (2 * o[0] - rows + 1) ** 2 + 4 * o[1] ** 2)


def _k1_block(k, window):
    """The pixel rows and columns of a block of the kernel that serves
    (k, window): the specialised kernel's, or ``general_block``'s."""
    if (k, tuple(window)) == (knn_grid.KERNEL_K, knn_grid.KERNEL_WINDOW):
        return _K1_BLOCK
    tx, ty, _ = knn_grid.general_block(k, window)
    return knn_grid.ROWS * ty, tx


def _k1_emulate(points, valid, k=10, window=(5, 21)):
    """K1's schedule: each pixel takes the offsets of ``visit_order`` (the
    specialised kernel's compile-time order at (5, 21); the general
    kernel's table, ``general_order``, elsewhere) that fall in its window (its parity is its row in the
    thread), each distance rejected by one compare against buf[k-1] or
    inserted. Blocks (``_k1_block``) whose halo holds no valid point with a
    coordinate that is not finite add w (0 or +inf) to each distance; the
    others skip invalid candidates, count nan distances, and give nan when
    fewer than k of the window's values are not nan."""
    b, h, w = valid.shape
    wh, ww = window
    ph, pw = wh // 2, ww // 2
    pts = torch.where(valid[..., None], points, 0.0).float()
    pad_pts = F.pad(pts, (0, 0, pw, pw, ph, ph))
    pad_valid = F.pad(valid, (pw, pw, ph, ph))
    bad = valid & ~torch.isfinite(points).all(-1)
    near_bad = F.max_pool2d(bad.float()[:, None], (wh, ww), 1, (ph, pw))[:, 0, :h, :w] > 0
    bh, bw = _k1_block(k, window)
    nb_h, nb_w = -(-h // bh), -(-w // bw)
    flag = F.pad(near_bad, (0, nb_w * bw - w, 0, nb_h * bh - h)).reshape(
        b, nb_h, bh, nb_w, bw).any(4).any(2)
    exact = flag.repeat_interleave(bh, 1).repeat_interleave(bw, 2)[:, :h, :w]
    parity = (torch.arange(h) % 2)[:, None]
    cx, cy, cz = pts.unbind(-1)
    buf = torch.full((b, h, w, k), float("inf"))
    n_nan = torch.zeros((b, h, w), dtype=torch.long)
    order = knn_grid.visit_order(window)
    if (k, tuple(window)) != (knn_grid.KERNEL_K, knn_grid.KERNEL_WINDOW):
        order = [o for part in knn_grid.general_order(window) for o in part]
    for dy, dx in order:
        for r in (0, 1):
            ry = dy - r
            if not -ph <= ry <= wh - 1 - ph:
                continue
            sx, sy, sz = pad_pts[:, ph + ry:ph + ry + h, pw + dx:pw + dx + w].unbind(-1)
            sv = pad_valid[:, ph + ry:ph + ry + h, pw + dx:pw + dx + w]
            ex, ey, ez = cx - sx, cy - sy, cz - sz
            d2 = ex * ex + ey * ey + ez * ez
            mine = valid & (parity == r)
            use = torch.where(exact, torch.where(sv, d2, float("inf")),
                              d2 + torch.where(sv, 0.0, float("inf")))
            n_nan += (mine & exact & sv & d2.isnan()).long()
            take = mine & (use < buf[..., -1])
            buf = torch.sort(torch.cat([buf, torch.where(take, use, float("inf"))[..., None]], -1),
                             -1).values[..., :k]
    roots = torch.sqrt(buf.double()).float()
    acc = torch.zeros_like(cx)
    for j in range(k):
        acc = acc + roots[..., j]
    res = acc / acc.new_tensor(float(k))
    res = torch.where(exact & (n_nan > wh * ww - k), float("nan"), res)
    return torch.where(valid, res, float("inf"))


def _k1_grids():
    """(3, 40, 96) grids: an analytic scene's road, 15% of it valid (windows
    with fewer than k valid points), the same scene with zero-disparity
    patches (valid +-inf and nan points, a patch where every distance is
    nan), and random points 30% valid."""
    h, w = 40, 96
    cfg = config.munich_pipeline_config(input_height=h, input_width=w)
    _, labels, disp_norm = scene_pool(1, h, w, seed=2)[:3]
    disp = torch.from_numpy(disp_norm * np.float32(2048.0 * w / 512.0))
    pts = camera.reproject_disparity(disp, cfg.camera)[0]
    rng = np.random.default_rng(9)
    road = torch.from_numpy((labels[0] == 7) & (rng.random((h, w)) < 0.15))
    zero = disp.clone()
    zero[0, 5:12, 10:40] = 0.0  # +-inf points, and nan where a pixel sits at cx or cy
    zero[0, 30:36, 60:70] = 0.0
    inf_pts = camera.reproject_disparity(zero, cfg.camera)[0]
    inf_pts[20:27, 70:95] = torch.tensor([float("inf"), float("inf"), float("-inf")])
    inf_valid = torch.ones((h, w), dtype=torch.bool)
    inf_valid[::3, 1::4] = False
    rnd = torch.from_numpy((rng.normal(size=(h, w, 3)) * [2.0, 0.3, 5.0]).astype(np.float32))
    rnd_valid = torch.from_numpy(rng.random((h, w)) < 0.3)
    return (torch.stack([pts, inf_pts, rnd]).contiguous(),
            torch.stack([road, inf_valid, rnd_valid]).contiguous())


def test_k1_near_first_order_with_early_reject_is_bit_equal():
    points, valid = _k1_grids()
    want = knn_grid.knn_mean_distances_grid_plain(points, valid, 10, (5, 21))
    got = _k1_emulate(points, valid)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    # the cases are there: windows short of k valid points, nan means from
    # the all-nan patch, finite means next to inf points
    road = want[0][valid[0]]
    assert bool(torch.isinf(road).any()) and bool(torch.isfinite(road).any())
    assert bool(want[1].isnan().any()) and bool(torch.isfinite(want[1]).any())


@pytest.mark.parametrize("k, window", _K1_GENERAL)
def test_k1_general_kernel_schedule_is_bit_equal(k, window):
    """The general kernel's schedule: the host-built order table, its block
    shape's exact-path blocks, and the k smallest of its buffers."""
    points, valid = _k1_grids()
    want = knn_grid.knn_mean_distances_grid_plain(points, valid, k, window)
    got = _k1_emulate(points, valid, k, window)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert bool(torch.isfinite(want[valid]).any())


@pytest.mark.parametrize("window", [(5, 21)] + [w for _, w in _K1_GENERAL] + [(1, 1), (6, 7)])
def test_k1_order_is_the_union_of_both_windows_nearest_first(window):
    """The wrapper's table is the specialised kernel's compile-time order at
    (5, 21) and the same rule elsewhere: each pixel's own window, once each,
    nearest to the thread's two pixels first; packed as the kernel reads it."""
    wh, ww = window
    ph, pw = wh // 2, ww // 2
    order = knn_grid.visit_order(window)
    assert order == _k1_order(window)
    assert len(order) == len(set(order)) == (wh + 1) * ww
    assert order[:2] == [(0, 0), (1, 0)] or wh == 1 and order[0] == (0, 0)
    keys = [(2 * dy - 1) ** 2 + 4 * dx * dx for dy, dx in order]
    assert keys == sorted(keys)
    for r in (0, 1):  # each pixel's own wh x ww window, once each
        mine = [(dy - r, dx) for dy, dx in order if -ph <= dy - r <= wh - 1 - ph]
        assert sorted(mine) == [(y, x) for y in range(-ph, wh - ph) for x in range(-pw, ww - pw)]
    tx = knn_grid.general_block(1, window)[0]
    sw = tx + ww - 1  # the halo tile's row: an entry is the offset dy * sw + dx
    table = knn_grid._order_table(tuple(window), tx, torch.device("cpu")).tolist()
    decoded = [((e + pw) // sw, (e + pw) % sw - pw) for e in table]
    assert decoded == [o for part in knn_grid.general_order(window) for o in part]
    assert sorted(decoded) == sorted(order)


def test_k1_general_block_fits_the_shared_memory_or_raises():
    """The largest block whose halo (and, past k = 32, buffers) fits; a
    window no block's halo fits raises, naming the limit."""
    assert knn_grid.general_block(10, (7, 31)) == (32, 8, (16 + 6) * (32 + 30) * 16)
    tx, ty, smem = knn_grid.general_block(100, (9, 33))
    assert smem == (2 * ty + 8) * (tx + 32) * 16 + 2 * tx * ty * (100 - 32) * 4 <= 227 * 1024
    assert (tx, ty) == (32, 8)
    assert knn_grid.general_block(10, (61, 211))[:2] == (16, 1)  # (32, 1): 240064 bytes
    with pytest.raises(ValueError, match="232448 bytes"):
        knn_grid.general_block(10, (301, 301))


@pytest.mark.parametrize("window", [(7, 31), (4, 20), (1, 1), (2, 2), (9, 33)])
def test_k1_general_order_splits_the_order_by_rows(window):
    """The general kernel's table: the offsets both pixels take, then the
    first pixel's top row, then the second's bottom row, each part nearest
    first, together the union ``visit_order`` holds."""
    wh, ww = window
    ph = wh // 2
    both, top, bottom = knn_grid.general_order(window)
    assert [len(both), len(top), len(bottom)] == [(wh - 1) * ww, ww, ww]
    assert all(-ph < dy < wh - ph for dy, _ in both)
    assert {dy for dy, _ in top} == {-ph} and {dy for dy, _ in bottom} == {wh - ph}
    for part in (both, top, bottom):
        keys = [(2 * dy - 1) ** 2 + 4 * dx * dx for dy, dx in part]
        assert keys == sorted(keys)
    assert sorted(both + top + bottom) == sorted(knn_grid.visit_order(window))


# --- the k > 32 buffers: csrc/kselect.cuh and the large-k far walk's merge ---


def _insertion_sort(values):
    out = list(values)
    for i in range(1, len(out)):
        v, j = out[i], i
        while j > 0 and out[j - 1] > v:
            out[j] = out[j - 1]
            j -= 1
        out[j] = v
    return out


def _kselect(values, k):
    """csrc/kselect.cuh on one thread's candidates in the kernel's order: a
    value below thr (never nan or +inf) enters the 32 registers' min/max
    network; what leaves it (+inf while they are not full) takes the
    buffer's next slot, then the slot of its largest; thr is the buffer's
    largest once it holds k - 32. Returns the values held, ascending: the
    registers' finite ones, then the buffer sorted."""
    reg, buf, thr, at = [float("inf")] * 32, [], float("inf"), 0
    for v in values:
        if not v < thr:
            continue
        for j in range(32):
            reg[j], v = min(reg[j], v), max(reg[j], v)
        if not v < float("inf"):
            continue
        if len(buf) < k - 32:
            buf.append(v)
        else:
            buf[at] = v
        if len(buf) == k - 32:
            thr = max(buf)
            at = buf.index(thr)
    assert all(r <= x for r in reg for x in buf)  # every buffer value above the registers'
    return [r for r in reg if r < float("inf")] + _insertion_sort(buf)


def _sum_roots(values):
    """float32 roots (via float64, as __fsqrt_rn) summed in the given order."""
    acc = torch.zeros((), dtype=torch.float32)
    for v in torch.sqrt(torch.tensor(values, dtype=torch.float64)).float():
        acc = acc + v
    return acc


def _drawn_row(seed, n):
    """(n,) float32 distances: ties from a small pool, +inf and nan mixed in."""
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, 0.25, 0.25, 1.0, 3.5, 3.5, 7.0], np.float32)
    vals = np.where(rng.random(n) < 0.4, rng.choice(pool, n),
                    rng.random(n).astype(np.float32) * 8).astype(np.float32)
    vals[rng.random(n) < rng.choice([0.0, 0.1, 0.6])] = np.inf
    vals[rng.random(n) < rng.choice([0.0, 0.05, 0.5])] = np.nan
    return vals


@settings(max_examples=60, deadline=None, database=None)
@given(seed=st.integers(0, 2**32 - 1), n=st.integers(33, 300), k=st.integers(33, 300))
def test_kselect_buffer_keeps_the_k_smallest_like_topk(seed, n, k):
    """The k > 32 buffers on drawn rows (ties, +inf, nan, fewer than k
    finite values): they hold the k smallest finite values, ascending, and
    K1's mean from it (+inf short of k values, nan past wh * ww - k nan
    distances) is bit-equal to the plain version's topk sum."""
    k = min(k, n)
    vals = _drawn_row(seed, n)
    held = _kselect(vals.tolist(), k)
    fin = np.sort(vals[np.isfinite(vals)])
    assert np.array_equal(np.array(held, np.float32), fin[:k])
    t = torch.from_numpy(vals)
    smallest = torch.topk(t, k, largest=False, sorted=True).values
    want = _sum_roots(smallest.tolist()) / torch.tensor(float(k))
    n_nan = int(np.isnan(vals).sum())
    got = (torch.tensor(float("nan")) if n_nan > n - k else
           torch.tensor(float("inf")) if len(held) < k else
           _sum_roots(held) / torch.tensor(float(k)))
    assert torch.equal(got.isnan(), want.isnan()) and torch.equal(got.nan_to_num(),
                                                                  want.nan_to_num())


def _bitonic(values):
    """csrc/exact_knn.cu::lk_merge's network on P padded with +inf to a power
    of two, compare-exchange by compare-exchange."""
    n = 1
    while n < len(values):
        n <<= 1
    p = list(values) + [float("inf")] * (n - len(values))
    size = 2
    while size <= n:
        stride = size >> 1
        while stride > 0:
            for t in range(n // 2):
                lo = (t // stride) * 2 * stride + t % stride
                hi = lo + stride
                if (p[lo] > p[hi]) == ((lo & size) == 0):
                    p[lo], p[hi] = p[hi], p[lo]
            stride >>= 1
        size <<= 1
    return p[:len(values)]


def _lk_merge(a, pending, k):
    """lk_merge: each value to its rank in the merged order (A's first on a
    tie), the ranks below k kept; every slot written once."""
    p = _bitonic(pending)
    out = [None] * k
    for i, v in enumerate(a):
        r = i + sum(x < v for x in p)
        if r < k:
            assert out[r] is None
            out[r] = v
    for j, v in enumerate(p):
        r = j + sum(x <= v for x in a)
        if r < k:
            assert out[r] is None
            out[r] = v
    return out


@settings(max_examples=40, deadline=None, database=None)
@given(seed=st.integers(0, 2**32 - 1), k=st.integers(33, 120), n_a=st.integers(0, 120),
       n_p=st.integers(1, 512))
def test_lk_merge_by_rank_is_the_sorted_union(seed, k, n_a, n_p):
    """The large-k far walk's merge: A the warp's k smallest so far (sorted,
    +inf past what it holds), P the pending candidates (finite, ties with A
    and among themselves): the result is the k smallest of both, ascending."""
    rng = np.random.default_rng(seed)
    pool = rng.random(16).astype(np.float32)
    draw = lambda m: np.where(rng.random(m) < 0.5, rng.choice(pool, m),
                              rng.random(m)).astype(np.float32)
    a = np.sort(draw(min(n_a, k))).tolist() + [float("inf")] * (k - min(n_a, k))
    p = draw(n_p).tolist()
    got = _lk_merge(a, p, k)
    assert got == np.sort(np.array(a + p, np.float32))[:k].tolist()
    assert _bitonic(p) == sorted(p)


_K4_LARGE = [("road", 50, True), ("road", 33, False), ("outliers", 50, True),
             ("outliers", 40, True), ("edge", 64, True), ("edge", 100, False), ("blob", 100, True)]


@pytest.mark.parametrize("case,k,skip", _K4_LARGE)
def test_k4_large_k_schedule_is_bit_equal_to_the_plain_version(case, k, skip):
    """k > 32 keeps the k <= 32 schedule (near walk, tests, deferral) and
    searches a deferred query again from its near walk's k-th distance: the
    emulated schedule equals the plain version; its counts at k = 50 against
    k = 10's show the search's growth."""
    xyz, valid = _K4_CASES[case]()
    got, stats = k4.emulate(xyz, valid, k, skip)
    assert torch.equal(got, exact_knn.knn_mean_distances_exact_plain(xyz, valid, k))
    if not skip:
        assert stats["deferred"] == 0 and stats["subtile_tests"] == 0 and stats["pairs_far"] == 0
        return
    if case == "outliers":  # outliers leave their warps, and the far walk finds their k
        assert stats["deferred"] > 0 and stats["pairs_far"] > 0
    if case == "road":
        small = k4.emulate(xyz, valid, 10, skip)[1]
        n = valid.sum(-1).double()
        assert small["pairs_near"] <= stats["pairs_near"] < 0.5 * float((n * n).sum())


def test_k4_large_k_scratch_and_layout():
    """scratch_words for k > 32 holds the deferred rows and k-th distances
    (no per-query buffer), and the buffers (the k - 32 values past the
    registers) only where ``large_k_layout`` puts them in the scratch; the
    layout takes the most warps that fit."""
    b, c = 3, 5000
    s, cp, g = -(-c // 32), -(-c // 32) * 32, -(-c // 1024)
    base = b * (cp * 4 + s * 8 + g * 8) + 16
    assert exact_knn.scratch_words(b, c, 10) == base + b * (cp * 10 + cp)
    assert exact_knn.large_k_layout(50) == (4, True)  # 4 x (1536 + 64 x 18 x 4) bytes
    assert exact_knn.large_k_layout(253) == (4, True) and exact_knn.large_k_layout(254) == (2, True)
    assert exact_knn.large_k_layout(934) == (1, True)
    assert exact_knn.large_k_layout(935) == (4, False)
    assert exact_knn.scratch_words(b, c, 50) == base + 2 * b * cp
    assert exact_knn.scratch_words(b, c, 50) < exact_knn.scratch_words(b, c, 32)
    near = b * -(-cp // 256) * 256 * (1000 - 32)
    assert exact_knn.scratch_words(b, c, 1000) == base + 2 * b * cp + near + 264 * 4 * 2512
    # small limits take fewer warps, then move the buffers into the scratch
    assert exact_knn.large_k_layout(50, 12 * 1024) == (2, True)
    assert exact_knn.large_k_layout(50, 8 * 1024) == (4, False)


def test_k4_chunks_stay_below_the_launch_limits():
    """max_frames: 65535 frames a launch, fewer where the padded rows would
    reach 2^31 (the deferred list's 32-bit row ids); a frame too large for
    one launch raises, naming the limit."""
    assert exact_knn.max_frames(4) == 65535 and exact_knn.max_frames(32768) == 65535
    assert exact_knn.max_frames(131072) == 16383
    assert exact_knn.max_frames(131072) * 131072 < 2 ** 31
    with pytest.raises(ValueError, match="2147483647 rows"):
        exact_knn.max_frames(2 ** 31)


# --- the measured variants and K4's bound ------------------------------------

REPO = Path(__file__).resolve().parent.parent


def _load(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["k4_near_only", "k4_in_warp_far", "k4_no_counters",
                                  "k1_branch_only"])
def test_knn_variants_patch_only_their_kernel_source(name, tmp_path):
    """tools/knn_variants.py still finds each text it replaces (once), and a
    variant differs from this checkout in its own kernel's source alone."""
    variants = _load(REPO / "tools" / "knn_variants.py")
    dst = variants.make(name, tmp_path)
    changed = [rel for rel in (variants.K1, variants.K4)
               if (dst / rel).read_text() != (REPO / rel).read_text()]
    assert changed == [variants.VARIANTS[name][0][0]]
    assert (dst / "chip_smoke.py").read_bytes() == (REPO / "chip_smoke.py").read_bytes()
    assert (dst / "tools" / "time_knn.py").is_file()


def test_exact_knn_bound_reads_the_inputs_alone():
    """chip_smoke.py's K4 bound: each point read and each mean written once
    against each valid query's min(k, n) pairs, whatever the coordinates;
    all n^2 pairs only beside it."""
    smoke = _load(REPO / "chip_smoke.py")
    valid = torch.zeros((2, 1000), dtype=torch.bool)
    valid[0, :600] = True
    valid[1, :4] = True
    ms, by, needed, ms_all, pairs_all = smoke.exact_knn_bound(valid)
    assert needed == 600 * 10 + 4 * 4 and pairs_all == 600 ** 2 + 4 ** 2
    assert by == "bytes" and ms == 2 * 1000 * 17 / smoke._HBM_BYTES_PER_S * 1e3
    assert ms_all > ms


@pytest.mark.parametrize("k, window", [(10, (5, 21)), (20, (7, 31)), (6, (4, 20))])
def test_knn_grid_bound_counts_what_the_function_needs(k, window):
    """chip_smoke.py's K1 bound: 9 operations for each (valid pixel, valid
    candidate) pair of the window, JAX's offsets for an even one, whatever
    k is, and 2k + 1 for each valid pixel with at least k candidates."""
    smoke = _load(REPO / "chip_smoke.py")
    smoke._HBM_BYTES_PER_S = float("inf")  # the operations alone
    valid = np.random.default_rng(k).random((2, 12, 40)) < 0.5
    (wh, ww), pairs, full = window, 0, 0
    for b, i, j in zip(*np.nonzero(valid)):
        n = int(valid[b, max(i - wh // 2, 0):i - wh // 2 + wh,
                      max(j - ww // 2, 0):j - ww // 2 + ww].sum())
        pairs, full = pairs + n, full + (n >= k)
    ms, by = smoke.knn_grid_bound(torch.from_numpy(valid), k, window)
    assert by == "operations" and full > 0
    assert ms == pytest.approx((9 * pairs + (2 * k + 1) * full) / smoke._FP32_FLOPS * 1e3,
                               rel=1e-12)
