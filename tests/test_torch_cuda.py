"""The PyTorch port on a CUDA card: each hand-written kernel against its
plain version, the wrappers' argument checks, and the frame program on the
card against the CPU. Every test here needs a card (marker ``gpu``) and
skips without one. This file imports no JAX, so it also runs where only
the port's dependencies exist:

    python -m pytest tests/test_torch_cuda.py -q -m gpu --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from semantic_depth_tpu_torch import config, pipeline
from semantic_depth_tpu_torch.models import FCN8s, Monodepth
from semantic_depth_tpu_torch.ops import knn_grid, mad, radius
from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

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
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    # same float32 operations in the same order (no FMA, IEEE sqrt/div)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-6)


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


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    p = torch.zeros((1, 32, 64, 3), device=cuda)
    v = torch.ones((1, 32, 64), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        knn_grid.knn_mean_distances_grid(p.double(), v, 10)
    with pytest.raises(ValueError):
        knn_grid.knn_mean_distances_grid(p, v, 5)  # no such instantiation
    with pytest.raises(ValueError):
        knn_grid.knn_mean_distances_grid(p.transpose(1, 2).contiguous().transpose(1, 2), v, 10)
    vals = torch.zeros((2, 1024), device=cuda)
    ok = torch.ones((2, 1024), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        mad.mad_keep_mask(vals, ok, torch.ones(3, device=cuda))
    with pytest.raises(ValueError):
        mad.mad_keep_mask(vals[:, :1022], ok[:, :1022], torch.ones(2, device=cuda))
    with pytest.raises(ValueError):
        radius.radius_counts(torch.zeros((1, 100, 3), device=cuda),
                             torch.ones((1, 100), dtype=torch.bool, device=cuda),
                             torch.ones((1, 100), device=cuda), 0.5)


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
    counters = (knn_grid.knn_mean_distances_grid, mad.mad_keep_mask, radius.radius_counts)
    for fn in counters:
        fn.launches = 0
    out = pipe.process_batch(scene_pool(2, 384, 768, seed=5)[0], disparity_mult=100.0)
    assert [fn.launches for fn in counters] == [1, 4, 1]
    assert out.disparity.device.type == "cuda" and out.disparity.shape == (2, 128, 256)
