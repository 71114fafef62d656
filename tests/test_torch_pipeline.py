"""The ported frame program as a whole against the JAX pipeline on the CPU:
the tiny-network pipeline of tests/test_pipeline.py mapped across, the
batch against the single-frame entry, and the geometry tail on a rendered
analytic scene under the full ``munich_pipeline_config()``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_depth_tpu import config as jconfig
from semantic_depth_tpu import pipeline as jpipeline
from semantic_depth_tpu.models import FCN8s as JaxFCN8s
from semantic_depth_tpu.models import Monodepth as JaxMonodepth
from semantic_depth_tpu_torch import config as tconfig
from semantic_depth_tpu_torch import graphs as tgraphs
from semantic_depth_tpu_torch import pipeline as tpipeline
from semantic_depth_tpu_torch.models import FCN8s, Monodepth
from semantic_depth_tpu_torch.models.from_flax import load_flax
from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

from torch_helpers import numpy_params

torch.set_num_threads(2)  # six xdist workers share the machine


def _tiny_cfg(config_mod):
    base = config_mod.munich_pipeline_config()
    return config_mod.munich_pipeline_config(
        input_height=128, input_width=256,
        road=dataclasses.replace(base.road, neighbor_capacity=2048),
    )


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX tiny pipeline of tests/test_pipeline.py and the port's, on the
    same numpy-seeded parameters."""
    jfcn = JaxFCN8s(num_classes=3, width_mult=0.0625, fc_channels=32)
    jmono = JaxMonodepth(encoder="vgg", width_mult=0.0625)
    x = np.zeros((1, 128, 256, 3), np.float32)
    fcn_params = numpy_params(jfcn, x, seed=0)
    mono_params = numpy_params(jmono, np.zeros((2, 128, 256, 3), np.float32), seed=1)
    jpipe = jpipeline.SemanticDepthPipeline(
        _tiny_cfg(jconfig), fcn_params, mono_params, fcn=jfcn, mono=jmono)
    tpipe = tpipeline.SemanticDepthPipeline(
        _tiny_cfg(tconfig),
        load_flax(FCN8s(num_classes=3, width_mult=0.0625, fc_channels=32), fcn_params),
        load_flax(Monodepth("vgg", width_mult=0.0625), mono_params),
        device="cpu",
    )
    frames = scene_pool(2, 384, 768, seed=5)[0]  # (2, 384, 768, 3) uint8 BGR
    return jpipe, tpipe, frames


def _nan_close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=atol, equal_nan=True)


def test_process_batch_matches_jax(tiny_pair):
    jpipe, tpipe, frames = tiny_pair
    # a small multiplier puts the random network's disparity 10-30 m away,
    # past the road chain's 7 m cut, so the fence chain measures something
    want = jpipe.process_batch(frames, disparity_mult=100.0)
    got = tpipe.process_batch(frames, disparity_mult=100.0)
    assert got.disparity.shape == (2, 128, 256) and got.points3d.shape == (2, 128, 256, 3)
    assert got.road_mask.dtype == torch.bool
    small_diff = np.abs(got.frame_small.numpy() - np.asarray(want.frame_small))
    assert small_diff.max() <= 1.0 and (small_diff > 0).mean() < 1e-3  # resize rounding
    # masks are softmax > 0.5 on logits that agree to ~1e-6: a pixel on the
    # threshold may flip
    for name in ("road_mask", "fence_mask"):
        assert (getattr(got, name).numpy() != np.asarray(getattr(want, name))).mean() < 1e-3
    _nan_close(got.disparity.numpy(), np.asarray(want.disparity), atol=1e-3)
    ov = got.overlay_small.numpy()
    assert ov.min() >= 0 and ov.max() <= 255
    # Random networks give degenerate clouds: plane intersections far off
    # (tens to hundreds of metres) that amplify the ~1e-6 relative
    # disparity difference of the two convolution orders. Agreement is to
    # 1e-3 relative here; the 1e-3 m check on identical inputs is
    # test_geometry_tail_on_analytic_scene_matches_jax.
    assert np.isfinite(np.asarray(want.dist_f2f)).any()
    np.testing.assert_allclose(got.dist_rw.numpy(), np.asarray(want.dist_rw),
                               rtol=1e-3, equal_nan=True)
    np.testing.assert_allclose(got.dist_f2f.numpy(), np.asarray(want.dist_f2f),
                               rtol=1e-3, equal_nan=True)


def test_process_batch_matches_single_frames(tiny_pair):
    _, tpipe, frames = tiny_pair
    batch = tpipe.process_batch(frames)
    for i in range(2):
        single = tpipe.process_frame(frames[i])
        for f in ("disparity", "road_mask", "fence_mask", "overlay_small", "points3d"):
            np.testing.assert_array_equal(getattr(single, f).numpy(), getattr(batch, f)[i].numpy())
        _nan_close(single.dist_rw.numpy(), batch.dist_rw[i].numpy(), atol=0)
        _nan_close(single.dist_f2f.numpy(), batch.dist_f2f[i].numpy(), atol=0)
    # the multiplier defaults to the ORIGINAL frame width
    assert float(batch.disparity.max()) <= 0.3 * 768 + 1e-3


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipeline.SemanticDepthPipeline(
            tconfig.munich_pipeline_config(), FCN8s(width_mult=0.0625, fc_channels=8),
            Monodepth(width_mult=0.0625))


def test_geometry_tail_on_analytic_scene_matches_jax():
    imgs, labels, disp_norm, rw_true, f2f_true = scene_pool(1, 256, 512, seed=0)
    small = imgs.astype(np.float32)
    road, fence = labels == 7, labels == 13
    disp = (disp_norm * np.float32(2048.0)).astype(np.float32)

    jcfg = jconfig.munich_pipeline_config()
    jpipe = jpipeline.SemanticDepthPipeline.__new__(jpipeline.SemanticDepthPipeline)
    jpipe.config = jcfg  # the geometry tail reads only the config
    jcam, _ = jpipeline._scaled_camera(jcfg, jnp.float32(jcfg.camera.focal))
    want = jpipe._batch_geometry(
        jnp.asarray(small), jnp.asarray(road), jnp.asarray(fence), jnp.asarray(disp), jcam)

    tcfg = tconfig.munich_pipeline_config()
    tpipe = tpipeline.SemanticDepthPipeline.__new__(tpipeline.SemanticDepthPipeline)
    tpipe.config = tcfg
    tpipe.tail_graphs = tgraphs.Cache()
    tcam, _ = tpipeline._scaled_camera(tcfg, tcfg.camera.focal)
    with torch.inference_mode():
        got = tpipe._batch_geometry(
            torch.from_numpy(small), torch.from_numpy(road), torch.from_numpy(fence),
            torch.from_numpy(disp), tcam)

    assert bool(got.rw_found[0])
    _nan_close(got.dist_rw.numpy(), np.asarray(want.dist_rw), atol=1e-3)
    _nan_close(got.dist_f2f.numpy(), np.asarray(want.dist_f2f), atol=1e-3)
    np.testing.assert_allclose(got.road_plane.numpy(), np.asarray(want.road_plane),
                               rtol=0, atol=1e-4)
    # and the measurement itself: the analytic road width, to a few cm
    assert abs(float(got.dist_rw[0]) - float(rw_true[0])) < 0.1
    assert abs(float(got.dist_f2f[0]) - float(f2f_true[0])) < 0.1
