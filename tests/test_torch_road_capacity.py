"""The road tail at a neighbour capacity off the kernels' tiles
(``neighbor_capacity=1000``: K3's CUDA op pads it to 1024 candidates) on
the CPU, where the port takes the plain versions, against the JAX
package's ``_batch_geometry`` on the same noisy scenes, grid and exact
mode. The card's side of the same check is in ``chip_smoke.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_depth_tpu import config as jconfig
from semantic_depth_tpu import pipeline as jpipeline
from semantic_depth_tpu_torch import config as tconfig
from semantic_depth_tpu_torch import graphs as tgraphs
from semantic_depth_tpu_torch import pipeline as tpipeline
from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

torch.set_num_threads(2)  # six xdist workers share the machine

H, W = 128, 256
CAPACITY = 1000


def noisy_scenes(n=2, seed=3):
    """Analytic scenes with 3% multiplicative disparity noise and 5% of the
    road and fence pixels punched out of their masks."""
    imgs, labels, disp_norm = scene_pool(n, H, W, seed=seed)[:3]
    rng = np.random.default_rng(seed)
    disp = disp_norm * np.float32(2048.0 * W / 512.0)
    disp = (disp * (1.0 + 0.03 * rng.standard_normal(disp.shape))).astype(np.float32)
    keep = rng.random(labels.shape) >= 0.05
    return (imgs.astype(np.float32), (labels == 7) & keep, (labels == 13) & keep, disp)


def _cfg(config_mod, stat_mode):
    base = config_mod.munich_pipeline_config(input_height=H, input_width=W)
    return dataclasses.replace(base, road=dataclasses.replace(
        base.road, stat_mode=stat_mode, neighbor_capacity=CAPACITY))


@pytest.mark.parametrize("stat_mode", ["grid", "exact"])
def test_road_tail_at_capacity_1000_matches_jax(stat_mode):
    small, road, fence, disp = noisy_scenes()
    jcfg = _cfg(jconfig, stat_mode)
    jpipe = jpipeline.SemanticDepthPipeline.__new__(jpipeline.SemanticDepthPipeline)
    jpipe.config = jcfg  # the geometry tail reads only the config
    jcam, _ = jpipeline._scaled_camera(jcfg, jnp.float32(jcfg.camera.focal))
    want = jpipe._batch_geometry(*map(jnp.asarray, (small, road, fence, disp)), jcam)

    tcfg = _cfg(tconfig, stat_mode)
    tpipe = tpipeline.SemanticDepthPipeline.__new__(tpipeline.SemanticDepthPipeline)
    tpipe.config = tcfg
    tpipe.tail_graphs = tgraphs.Cache()
    tcam, _ = tpipeline._scaled_camera(tcfg, tcfg.camera.focal)
    with torch.inference_mode():
        got = tpipe._batch_geometry(*map(torch.from_numpy, (small, road, fence, disp)), tcam)

    assert got.road_cloud.valid.shape == (2, CAPACITY)
    assert bool(got.rw_found.all()) and np.isfinite(got.dist_f2f.numpy()).all()
    np.testing.assert_array_equal(got.dist_rw.numpy(), np.asarray(want.dist_rw))
    np.testing.assert_allclose(got.dist_f2f.numpy(), np.asarray(want.dist_f2f), rtol=0, atol=1e-5)
    valid = got.road_cloud.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(want.road_cloud.valid))
    np.testing.assert_array_equal(got.road_cloud.xyz.numpy()[valid],
                                  np.asarray(want.road_cloud.xyz)[valid])
