"""PyTorch port against the JAX package: the masked point-cloud geometry of
``ops/pcl.py``, on clouds with +-inf rows, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_depth_tpu.ops import pcl as jpcl
from semantic_depth_tpu_torch.ops import pcl as tpcl

torch.set_num_threads(2)  # six xdist workers share the machine


def _cloud(seed, n=4096, inf_rows=True, valid_frac=0.7):
    """A noisy road-like plane y = 0.02 x - 0.01 z - 1.5 in front of the
    camera, with +-inf rows (what d == 0 back-projects to) among valid and
    invalid points."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-5, 5, n)
    z = rng.uniform(-30, -5, n)
    y = 0.02 * x - 0.01 * z - 1.5 + rng.normal(0, 0.03, n)
    xyz = np.stack([x, y, z], -1).astype(np.float32)
    xyz[rng.random(n) < 0.02] *= 40.0  # outliers
    if inf_rows:
        rows = rng.choice(n, 40, replace=False)
        xyz[rows] = np.float32(np.inf) * np.sign(rng.normal(size=(40, 3))).astype(np.float32)
    rgb = rng.uniform(0, 255, (n, 3)).astype(np.float32)
    valid = rng.random(n) < valid_frac
    return xyz, rgb, valid


def _both(xyz, rgb, valid):
    return (
        jpcl.MaskedCloud(jnp.asarray(xyz), jnp.asarray(rgb), jnp.asarray(valid)),
        tpcl.MaskedCloud(torch.from_numpy(xyz), torch.from_numpy(rgb), torch.from_numpy(valid)),
    )


def _finite_valid(xyz, valid):
    return valid & np.isfinite(xyz).all(-1)


def test_from_dense_and_masked_reductions():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(2, 8, 16, 3)).astype(np.float32)
    mask = rng.random((2, 8, 16)) < 0.5
    c = tpcl.from_dense(torch.from_numpy(pts), torch.from_numpy(pts), torch.from_numpy(mask))
    assert c.xyz.shape == (2, 128, 3) and c.valid.shape == (2, 128) and c.capacity == 128
    np.testing.assert_array_equal(c.count().numpy(), mask.reshape(2, -1).sum(-1))
    xyz, rgb, valid = _cloud(1)
    vals, ok = xyz[:, 0], _finite_valid(xyz, valid)
    tv, tok = torch.from_numpy(vals), torch.from_numpy(ok)
    for name in ("masked_sum", "masked_mean", "masked_min", "masked_max"):
        want = float(getattr(jpcl, name)(jnp.asarray(vals), jnp.asarray(ok)))
        got = float(getattr(tpcl, name)(tv, tok))
        # a float32 sum over 4096 values in another order: a few ulps
        assert got == pytest.approx(want, rel=1e-5, abs=1e-4), name


@pytest.mark.parametrize("seed", range(6))
def test_masked_median_fuzz_against_numpy(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 300))
    vals = rng.normal(size=(3, n)).astype(np.float32)
    if seed % 2:
        vals = np.round(vals * 3)  # heavy duplicates
    valid = rng.random((3, n)) < rng.uniform(0.05, 1.0)
    valid[2] = False  # an empty row -> nan
    got = tpcl.masked_median(torch.from_numpy(vals), torch.from_numpy(valid)).numpy()
    for r in range(3):
        want = np.median(vals[r][valid[r]]) if valid[r].any() else np.nan
        np.testing.assert_array_equal(got[r], np.float32(want))


@pytest.mark.parametrize("axis,threshold", [(1, 15.0), (0, 2.0), (1, 5.0)])
def test_mad_filter_matches_jax(axis, threshold):
    xyz, rgb, valid = _cloud(2)
    jc, tc = _both(xyz, rgb, valid)
    want = np.asarray(jpcl.mad_filter(jc, axis, threshold).valid)
    got = tpcl.mad_filter(tc, axis, threshold).valid.numpy()
    np.testing.assert_array_equal(got, want)  # exact medians: bit-equal masks


def test_mad_filter_pair_and_batch_match_jax():
    xa, ra, va = _cloud(3)
    xb, rb, vb = _cloud(4)
    ja, ta = _both(xa, ra, va)
    jb, tb = _both(xb, rb, vb)
    wa, wb = jpcl.mad_filter_pair(ja, jb, 0, 5.0, 1.0)
    ga, gb = tpcl.mad_filter_pair(ta, tb, 0, 5.0, 1.0)
    np.testing.assert_array_equal(ga.valid.numpy(), np.asarray(wa.valid))
    np.testing.assert_array_equal(gb.valid.numpy(), np.asarray(wb.valid))
    # a leading batch dimension: one call over both frames' rows
    batch = tpcl.MaskedCloud(torch.stack([ta.xyz, tb.xyz]), torch.stack([ta.rgb, tb.rgb]),
                             torch.stack([ta.valid, tb.valid]))
    got = tpcl.mad_filter(batch, 1, 15.0).valid.numpy()
    for i, jc in enumerate((ja, jb)):
        np.testing.assert_array_equal(got[i], np.asarray(jpcl.mad_filter(jc, 1, 15.0).valid))


def test_point_filters_match_jax():
    xyz, rgb, valid = _cloud(5)
    jc, tc = _both(xyz, rgb, valid)
    np.testing.assert_array_equal(
        tpcl.keep_beyond(tc, 2, 7.0).valid.numpy(), np.asarray(jpcl.keep_beyond(jc, 2, 7.0).valid))
    np.testing.assert_array_equal(
        tpcl.threshold_abs(tc, 2, 20.0).valid.numpy(),
        np.asarray(jpcl.threshold_abs(jc, 2, 20.0).valid))
    ok = _finite_valid(xyz, valid)
    jc, tc = _both(xyz, rgb, ok)
    for got, want in zip(tpcl.split_by_mean(tc, 0), jpcl.split_by_mean(jc, 0)):
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fit_plane_and_inlier_filter_match_jax(axis):
    xyz, rgb, valid = _cloud(6, inf_rows=False)
    xyz = xyz[:, [1, 0, 2]] if axis == 0 else xyz  # keep the regressed axis thin
    jc, tc = _both(xyz, rgb, valid)
    want = np.asarray(jpcl.fit_plane(jc, axis))
    got = tpcl.fit_plane(tc, axis).numpy()
    # centered float32 normal equations, sums in another order
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    jf, jp = jpcl.plane_inlier_filter(jc, axis, 0.05)
    tf, tp = tpcl.plane_inlier_filter(tc, axis, 0.05)
    mismatch = (tf.valid.numpy() != np.asarray(jf.valid)).sum()
    assert mismatch <= 2  # only residuals within an ulp of the threshold may flip


def test_plane_intersections_and_distance_match_jax():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(5, 4)).astype(np.float32)
    b = rng.normal(size=(5, 4)).astype(np.float32)
    got = tpcl.planes_intersection_at_depth(torch.from_numpy(a), torch.from_numpy(b), 10.0)
    for i in range(5):
        want = np.asarray(jpcl.planes_intersection_at_depth(jnp.asarray(a[i]), jnp.asarray(b[i]), 10.0))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-6, atol=1e-6)
    d = tpcl.distance_3d(torch.from_numpy(a[:, :3]), torch.from_numpy(b[:, :3])).numpy()
    for i in range(5):
        want = float(jpcl.distance_3d(jnp.asarray(a[i, :3]), jnp.asarray(b[i, :3])))
        assert d[i] == pytest.approx(want, rel=1e-6)


def test_road_endpoints_and_plane_edge_width_match_jax():
    xyz, rgb, valid = _cloud(8)
    ok = _finite_valid(xyz, valid)
    jc, tc = _both(xyz, rgb, ok)
    for depth in (9.98, 100.0):  # 100 m: an empty slab -> nan, found False
        jl, jr, jfound = jpcl.road_endpoints(jc, depth, 0.5)
        tl, tr, tfound = tpcl.road_endpoints(tc, depth, 0.5)
        assert bool(tfound) == bool(jfound)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        plane = jpcl.fit_plane(jc, 1)
        want = jpcl.plane_edge_width_cloud(jc, plane, 380.0, depth, 0.5)
        got = tpcl.plane_edge_width_cloud(tc, torch.tensor(np.asarray(plane)), 380.0, depth, 0.5)
        assert bool(got[2]) == bool(want[2])
        for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("capacity,px_scale", [(4096, 1.0), (1024, 1.0), (256, 4.0), (64, 1.0)])
def test_compact_slab_aware_matches_jax_row_for_row(capacity, px_scale):
    """No overflow, out-of-slab overflow, and the slab alone overflowing."""
    xyz, rgb, valid = _cloud(9, n=8192)
    jc, tc = _both(xyz, rgb, valid)
    lo, hi = -12.0, -8.0
    jp, jw = jpcl.compact_slab_aware(jc, capacity, 2, lo, hi, px_scale)
    tp, tw = tpcl.compact_slab_aware(tc, capacity, 2, lo, hi, px_scale)
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    v = np.asarray(jp.valid)
    np.testing.assert_array_equal(tp.xyz.numpy()[v], np.asarray(jp.xyz)[v])
    np.testing.assert_array_equal(tp.rgb.numpy()[v], np.asarray(jp.rgb)[v])
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    # batched: two frames in one call, each equal to its own call
    batch = tpcl.MaskedCloud(torch.stack([tc.xyz, tc.xyz.flip(0)]),
                             torch.stack([tc.rgb, tc.rgb.flip(0)]),
                             torch.stack([tc.valid, tc.valid.flip(0)]))
    bp, bw = tpcl.compact_slab_aware(batch, capacity, 2, lo, hi, px_scale)
    np.testing.assert_array_equal(bp.valid[0].numpy(), tp.valid.numpy())
    np.testing.assert_array_equal(bw[0].numpy(), tw.numpy())


def test_ranked_rows_matches_jax():
    rng = np.random.default_rng(10)
    ind = rng.random(3000) < 0.3
    csum = np.cumsum(ind).astype(np.int32)
    targets = np.arange(0, 1200, 3, dtype=np.int32) + 1  # some beyond csum[-1]
    want = np.asarray(jpcl._ranked_rows(jnp.asarray(csum), jnp.asarray(targets)))
    got = tpcl._ranked_rows(torch.from_numpy(csum), torch.from_numpy(targets)).numpy()
    np.testing.assert_array_equal(got, want)


# --- the pcl functions the JAX package's tests and tools use ---------------------


def test_masked_kth_smallest_matches_jax():
    """tests/test_pcl.py's case, plus a batch of rows with per-row k and an
    empty row (nan, as the JAX search ends at the all-ones pattern)."""
    rng = np.random.default_rng(1)
    vals = rng.normal(size=500).astype(np.float32)
    valid = rng.uniform(size=500) < 0.6
    n = int(valid.sum())
    for k in (0, 1, n // 2, n - 1, n):
        want = np.asarray(jpcl.masked_kth_smallest(jnp.asarray(vals), jnp.asarray(valid),
                                                   jnp.int32(k)))
        got = tpcl.masked_kth_smallest(torch.from_numpy(vals), torch.from_numpy(valid), k)
        np.testing.assert_array_equal(got.numpy(), want)
    rows = np.stack([vals, np.round(vals * 3), -vals])
    ok = np.stack([valid, valid, np.zeros(500, bool)])
    ks = np.array([3, 100, 0])
    got = tpcl.masked_kth_smallest(torch.from_numpy(rows), torch.from_numpy(ok),
                                   torch.from_numpy(ks)).numpy()
    for r in range(3):
        want = np.asarray(jpcl.masked_kth_smallest(jnp.asarray(rows[r]), jnp.asarray(ok[r]),
                                                   jnp.int32(ks[r])))
        np.testing.assert_array_equal(got[r], want)
    assert np.isnan(got[2])


def _road_mask(h, w, f, cx, cy, plane, half_width_of):
    """tests/test_pcl.py's analytic planar road: pixel (row, col) is road iff
    its ray meets the plane y = a x + c z + d within |x| <= half_width(z)."""
    a, _, c, d = plane
    u = np.arange(w, dtype=np.float64)[None, :] - cx
    v = cy - np.arange(h, dtype=np.float64)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        wz = d * f / (v - a * u + c * f)
        x = u * wz / f
    ok = np.isfinite(wz) & (wz > 1.0) & (wz < 60.0)
    return ok & (np.abs(x) <= half_width_of(wz)), wz


def test_plane_edge_width_matches_jax():
    """The flat and the tilted road of tests/test_pcl.py, a halo of false
    positives with and without the measured-range gate, poisoned rows for the
    MAD refit, and an empty mask, as one batch against per-frame JAX calls."""
    h, w, f = 256, 512, 500.0
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    flat = (0.0, -1.0, 0.0, -1.5)
    tilted = (0.02, -1.0, 0.015, -1.4)
    mask_flat, wz = _road_mask(h, w, f, cx, cy, flat, lambda z: 3.0)
    mask_tilt, _ = _road_mask(h, w, f, cx, cy, tilted, lambda z: 2.5 + 0.05 * (z - 10.0))
    halo, _ = _road_mask(h, w, f, cx, cy, flat, lambda z: 3.3)
    wide, _ = _road_mask(h, w, f, cx, cy, flat, lambda z: 5.0)
    poisoned = mask_flat.copy()
    r_lo, r_hi = int(cy + 1.5 * f / 10.5), int(cy + 1.5 * f / 9.5)
    for r in list(range(r_lo, r_hi + 1))[::4][:2]:
        poisoned[r] = wide[r]
    meas = np.where(mask_flat, wz, np.where(halo, wz * 1.10, np.nan)).astype(np.float32)
    cases = [(mask_flat, flat, None), (mask_tilt, tilted, None), (halo, flat, None),
             (halo, flat, meas), (poisoned, flat, None), (np.zeros((h, w), bool), flat, None)]
    masks = torch.from_numpy(np.stack([c[0] for c in cases]))
    planes = torch.tensor([c[1] for c in cases], dtype=torch.float32)
    meas_all = torch.from_numpy(np.stack(
        [c[2] if c[2] is not None else np.full((h, w), np.nan, np.float32) for c in cases]))
    gated = torch.tensor([c[2] is not None for c in cases])
    got_open = tpcl.plane_edge_width(masks, planes, cx, cy, f, 10.0)
    got_gated = tpcl.plane_edge_width(masks, planes, cx, cy, f, 10.0, meas_range=meas_all)
    for i, (mask, plane, m) in enumerate(cases):
        want = jpcl.plane_edge_width(jnp.asarray(mask), jnp.asarray(plane, jnp.float32),
                                     cx, cy, f, 10.0,
                                     meas_range=None if m is None else jnp.asarray(m))
        got = got_gated if gated[i] else got_open
        assert bool(got[2][i]) == bool(want[2]), i
        for g, wnt in zip((got[0][i], got[1][i], got[3][i]), (want[0], want[1], want[3])):
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-5, atol=1e-5,
                                       err_msg=str(i))
    assert abs(float(got_gated[3][3]) - 6.0) < 0.01 and float(got_open[3][2]) > 6.4


@pytest.mark.parametrize("capacity", [4096, 1024, 256])
def test_select_slab_priority_compact_and_stride_match_jax(capacity):
    """Fits, out-of-slab overflow, and the slab alone overflowing; two frames
    in one call, each equal to its JAX call (tests/test_pcl.py's composition)."""
    frames = [_cloud(11, n=8192), _cloud(12, n=8192, valid_frac=0.2)]
    lo, hi = -12.0, -8.0
    batch = tpcl.MaskedCloud(*(torch.from_numpy(np.stack([f[i] for f in frames]))
                               for i in range(3)))
    sel, stride = tpcl.select_slab_priority(batch, capacity, 2, lo, hi)
    packed = tpcl.compact(sel, capacity)
    resid = tpcl.compact_stride(sel, capacity)
    assert packed.xyz.shape == (2, capacity, 3)
    for i, (xyz, rgb, valid) in enumerate(frames):
        jc, _ = _both(xyz, rgb, valid)
        jsel, jstride = jpcl.select_slab_priority(jc, capacity, 2, lo, hi)
        np.testing.assert_array_equal(sel.valid[i].numpy(), np.asarray(jsel.valid))
        assert int(stride[i]) == int(jstride)
        assert int(resid[i]) == int(jpcl.compact_stride(jsel, capacity))
        jp = jpcl.compact(jsel, capacity)
        v = np.asarray(jp.valid)
        np.testing.assert_array_equal(packed.valid[i].numpy(), v)
        np.testing.assert_array_equal(packed.xyz[i].numpy()[v], np.asarray(jp.xyz)[v])
        np.testing.assert_array_equal(packed.rgb[i].numpy()[v], np.asarray(jp.rgb)[v])
