"""The three hand-written kernels' plain PyTorch versions against the JAX
package's Pallas kernels (interpret mode on the CPU) and jnp references.
The CUDA kernels themselves are tested on the card by test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_depth_tpu.ops import neighbors as jneighbors
from semantic_depth_tpu.ops import pcl as jpcl
from semantic_depth_tpu.ops.pallas_exact_knn import radius_counts_pallas
from semantic_depth_tpu.ops.pallas_knn import knn_mean_distances_grid_pallas
from semantic_depth_tpu.ops.pallas_mad import mad_keep_mask_pallas
from semantic_depth_tpu_torch.ops import _cuda, knn_grid, mad, radius

torch.set_num_threads(2)  # six xdist workers share the machine


def _grid(seed, h=64, w=128, b=None, frac=0.7):
    rng = np.random.default_rng(seed)
    shape = (h, w) if b is None else (b, h, w)
    pts = (rng.normal(size=shape + (3,)) * [2.0, 0.3, 5.0]).astype(np.float32)
    return pts, rng.random(shape) < frac


def test_launch_chunks_count_each_launch_that_finished():
    """The CUDA ops' chunk loop: ``(start, count)`` chunks of at most
    ``limit``, each counted under every key once its body has run, and a
    body that raises counted not at all."""
    before = _cuda.launches.copy()
    assert list(_cuda.launch_chunks(7, 3, "mad", "radius")) == [(0, 3), (3, 3), (6, 1)]
    assert list(_cuda.launch_chunks(0, 3, "mad")) == []
    with pytest.raises(RuntimeError):
        for start, _ in _cuda.launch_chunks(7, 3, "mad"):
            if start == 3:
                raise RuntimeError("refused launch")
    assert _cuda.launches - before == {"mad": 4, "radius": 3}


# --- K1: windowed kNN --------------------------------------------------------


def test_knn_grid_plain_matches_jax_stencil_and_pallas():
    pts, valid = _grid(0)
    ref = np.asarray(jneighbors.knn_mean_distances_grid(jnp.asarray(pts), jnp.asarray(valid), 10))
    pallas = np.asarray(knn_mean_distances_grid_pallas(
        jnp.asarray(pts), jnp.asarray(valid), 10, (5, 21), tile_h=16))
    got = knn_grid.knn_mean_distances_grid_plain(
        torch.from_numpy(pts), torch.from_numpy(valid), 10, (5, 21)).numpy()
    finite = np.isfinite(ref)
    assert finite.sum() > 1000
    for want in (ref, pallas):
        np.testing.assert_array_equal(np.isfinite(got), finite)
        # float32 sums of the same 10 square roots, possibly in another order
        np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-6)


def test_knn_grid_sparse_window_is_inf():
    pts = np.zeros((32, 128, 3), np.float32)
    valid = np.zeros((32, 128), bool)
    valid[5, 5] = True  # a lone point: 1 candidate < k
    valid[20, 40:52] = True  # a row of 12: every centre has >= 10 candidates
    got = knn_grid.knn_mean_distances_grid_plain(
        torch.from_numpy(pts), torch.from_numpy(valid), 10, (5, 21)).numpy()
    assert np.isinf(got[5, 5]) and np.isinf(got[0, 0])
    np.testing.assert_array_equal(got[20, 40:52], 0.0)  # coincident points


def test_knn_grid_batched_wrapper_on_cpu_is_the_plain_version():
    pts, valid = _grid(1, h=32, w=64, b=2)
    before = _cuda.launches.copy()
    got = knn_grid.knn_mean_distances_grid(torch.from_numpy(pts), torch.from_numpy(valid), 10)
    assert _cuda.launches == before  # no kernel on the CPU
    for i in range(2):
        want = np.asarray(jneighbors.knn_mean_distances_grid(
            jnp.asarray(pts[i]), jnp.asarray(valid[i]), 10))
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got[i].numpy()), fin)
        np.testing.assert_allclose(got[i].numpy()[fin], want[fin], rtol=1e-5, atol=1e-6)


# --- K2: MAD keep mask --------------------------------------------------------


def _mad_rows():
    rng = np.random.default_rng(2)
    n = 2048
    x = rng.normal(size=n).astype(np.float32) * 7 - 2
    with_inf = x.copy()
    with_inf[:30] = np.inf
    with_inf[30:50] = -np.inf
    odd = rng.random(n) < 0.5
    odd[0] = odd[1:].sum() % 2 == 0
    even = rng.random(n) < 0.5
    even[0] = even[1:].sum() % 2 == 1
    rows = [
        (x, rng.random(n) < 0.6, 2.0),
        (np.round(x), rng.random(n) < 0.6, 2.0),  # heavy duplicates
        (np.full(n, 3.25, np.float32), rng.random(n) < 0.5, 2.0),  # MAD = 0
        (x, np.zeros(n, bool), 2.0),  # empty
        (with_inf, rng.random(n) < 0.7, 5.0),  # +-inf values
        (x, odd, 15.0),
        (x, even, 1.0),
        (x, rng.random(n) < 0.002, 2.0),  # a handful of points
    ]
    return rows


@pytest.mark.parametrize("row", range(8))
def test_mad_plain_matches_pallas_bit_equal(row):
    vals, valid, thr = _mad_rows()[row]
    want = np.asarray(mad_keep_mask_pallas(jnp.asarray(vals), jnp.asarray(valid), thr))
    got = mad.mad_keep_mask_plain(
        torch.from_numpy(vals)[None], torch.from_numpy(valid)[None],
        torch.tensor([thr], dtype=torch.float32))[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_mad_rows_in_one_call_match_row_by_row():
    rows = _mad_rows()
    vals = torch.from_numpy(np.stack([r[0] for r in rows]))
    valid = torch.from_numpy(np.stack([r[1] for r in rows]))
    thr = torch.tensor([r[2] for r in rows], dtype=torch.float32)
    before = _cuda.launches.copy()
    got = mad.mad_keep_mask(vals, valid, thr)
    assert _cuda.launches == before
    for i in range(len(rows)):
        np.testing.assert_array_equal(
            got[i].numpy(), mad.mad_keep_mask_plain(vals[i:i + 1], valid[i:i + 1], thr[i:i + 1])[0])


def test_mad_plain_median_is_the_radix_median():
    """The plain version's order statistics are the JAX radix median's,
    nan included (a valid nan sorts above +inf in the ordered-uint32 map)."""
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(4, 1000)).astype(np.float32)
    vals[1, :10] = np.nan
    vals[2, :700] = np.inf
    valid = rng.random((4, 1000)) < 0.5
    n = torch.from_numpy(valid).sum(-1)
    got = mad._median_rows(torch.from_numpy(vals), torch.from_numpy(valid), n).numpy()
    for r in range(4):
        want = np.asarray(jpcl._masked_median_radix(jnp.asarray(vals[r]), jnp.asarray(valid[r])))
        np.testing.assert_array_equal(got[r], want)


# --- K3: weighted radius counts ----------------------------------------------


def _radius_cloud(seed, capacity=512, n=400, dyadic=True):
    rng = np.random.default_rng(seed)
    xyz = np.zeros((capacity, 3), np.float32)
    pts = rng.normal(size=(n, 3)) * [0.8, 0.1, 1.5] + [0.0, -1.5, -10.0]
    pts[:, 2] = np.sort(pts[:, 2])  # compacted clouds keep image (z) order
    if dyadic:  # multiples of 1/64: every summation order rounds alike
        pts = np.round(pts * 64) / 64
    xyz[:n] = pts
    xyz[n:] = np.inf  # inert garbage rows
    valid = np.zeros(capacity, bool)
    valid[:n] = rng.random(n) < 0.9
    weights = rng.choice([1.0, 2.0, 3.0, 0.5], size=capacity).astype(np.float32)
    return xyz, valid, weights


@pytest.mark.parametrize("weighted", [False, True])
def test_radius_plain_matches_pallas_and_jnp_on_dyadic_clouds(weighted):
    xyz, valid, weights = _radius_cloud(4)
    w = weights if weighted else valid.astype(np.float32)
    pallas = np.asarray(radius_counts_pallas(
        jnp.asarray(xyz), jnp.asarray(valid), 0.5, tq=128, cb=128,
        weights=jnp.asarray(w) if weighted else None))
    cloud = jpcl.MaskedCloud(jnp.asarray(np.where(valid[:, None], xyz, 0)),
                             jnp.asarray(xyz), jnp.asarray(valid))
    jw = jnp.where(jnp.asarray(valid), jnp.asarray(w), 0.0)
    ref = np.asarray(jneighbors.radius_counts_weighted(cloud, jw, 0.5, block_size=128))
    got = radius.radius_counts_plain(
        torch.from_numpy(xyz)[None], torch.from_numpy(valid)[None],
        torch.from_numpy(w)[None], 0.5)[0].numpy()
    assert got[valid].min() >= 1.0 or weighted  # every point counts itself
    np.testing.assert_array_equal(got, pallas.astype(np.float32))
    np.testing.assert_array_equal(got, ref)


def test_radius_plain_on_general_float_clouds():
    """Off the dyadic grid the Gram identity's rounding depends on the order
    of the three products: a pair at the radius may flip, on at most 0.1%
    of the rows."""
    xyz, valid, weights = _radius_cloud(5, capacity=1024, n=1000, dyadic=False)
    pallas = np.asarray(radius_counts_pallas(
        jnp.asarray(xyz), jnp.asarray(valid), 0.5, tq=128, cb=128, weights=jnp.asarray(weights)))
    got = radius.radius_counts_plain(
        torch.from_numpy(xyz)[None], torch.from_numpy(valid)[None],
        torch.from_numpy(weights)[None], 0.5)[0].numpy()
    assert (got != pallas).mean() <= 1e-3


def test_radius_batched_wrapper_on_cpu_is_the_plain_version():
    clouds = [_radius_cloud(s) for s in (6, 7)]
    xyz = torch.from_numpy(np.stack([c[0] for c in clouds]))
    valid = torch.from_numpy(np.stack([c[1] for c in clouds]))
    w = torch.from_numpy(np.stack([c[2] for c in clouds]))
    before = _cuda.launches.copy()
    got = radius.radius_counts(xyz, valid, w, 0.5)
    assert _cuda.launches == before
    for i in range(2):
        want = np.asarray(radius_counts_pallas(
            jnp.asarray(xyz[i].numpy()), jnp.asarray(valid[i].numpy()), 0.5, tq=128, cb=128,
            weights=jnp.asarray(w[i].numpy())))
        np.testing.assert_array_equal(got[i].numpy(), want)
