"""The designs of the K2 and K3 CUDA kernels, emulated in plain torch on the
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

The kernels themselves run on the card in test_torch_cuda.py."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from semantic_depth_tpu_torch.ops import mad, pcl, radius
from test_torch_kernels import _mad_rows



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
    and timing tool replay) records the grid geometry tail's four MAD calls
    (road y and x, fence y, the fence pair) and its one radius call, with
    the thresholds and the radius as plain numbers, and restores the
    wrappers afterwards."""
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
    assert torch.equal(got.dist_rw, want.dist_rw)
