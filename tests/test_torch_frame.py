"""PyTorch port against the JAX package: config presets, back-projection,
resize and overlay (the frame's front and back ends), on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_depth_tpu import camera as jcamera
from semantic_depth_tpu import config as jconfig
from semantic_depth_tpu.ops import overlay as joverlay
from semantic_depth_tpu.ops import resize as jresize
from semantic_depth_tpu_torch import camera as tcamera
from semantic_depth_tpu_torch import config as tconfig
from semantic_depth_tpu_torch.ops import overlay as toverlay
from semantic_depth_tpu_torch.ops import resize as tresize

torch.set_num_threads(2)  # six xdist workers share the machine


@pytest.mark.parametrize(
    "preset",
    ["munich_pipeline_config", "cityscapes_pipeline_config", "sequence_pipeline_config"],
)
def test_config_presets_match_field_by_field(preset):
    want = dataclasses.asdict(getattr(jconfig, preset)())
    got = dataclasses.asdict(getattr(tconfig, preset)())
    assert got == want
    assert dataclasses.asdict(tconfig.TrainConfig()) == dataclasses.asdict(jconfig.TrainConfig())


@pytest.mark.parametrize("cam_name", ["CAMERA_MUNICH", "CAMERA_CITYSCAPES"])
def test_reproject_disparity_matches_jax_including_zero_disparity(cam_name):
    rng = np.random.default_rng(0)
    disp = rng.uniform(0.5, 60.0, size=(64, 128)).astype(np.float32)
    disp[::7, ::5] = 0.0  # d == 0 -> +-inf points, as OpenCV leaves them
    want = np.asarray(jcamera.reproject_disparity(jnp.asarray(disp), getattr(jconfig, cam_name)))
    got = tcamera.reproject_disparity(torch.from_numpy(disp), getattr(tconfig, cam_name)).numpy()
    # same float32 operations in the same order: bit-equal, infs included
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[0, 0]).all()


def test_reproject_disparity_batched_matches_per_frame():
    rng = np.random.default_rng(1)
    disp = rng.uniform(0.5, 60.0, size=(3, 16, 32)).astype(np.float32)
    cam = tconfig.CAMERA_MUNICH
    got = tcamera.reproject_disparity(torch.from_numpy(disp), cam)
    for i in range(3):
        torch.testing.assert_close(
            got[i], tcamera.reproject_disparity(torch.from_numpy(disp[i]), cam), rtol=0, atol=0
        )


def test_resize_clip_u8_full_res_to_network_input():
    rng = np.random.default_rng(2)
    frame = rng.integers(0, 256, size=(1024, 2048, 3)).astype(np.float32)
    want = np.asarray(jresize.resize_clip_u8(jnp.asarray(frame), (256, 512)))
    got = tresize.resize_clip_u8(torch.from_numpy(frame), (256, 512)).numpy()
    # both are float32 matrix products summed in different orders, so a
    # value landing within an ulp of .5 may round the other way: at most
    # one level apart, and on a tiny fraction of the pixels
    diff = np.abs(got - want)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() < 1e-3
    # the interpolation matrices are the JAX package's, bit for bit
    np.testing.assert_array_equal(
        tresize._interp_matrix(1024, 256, "cubic"), jresize._interp_matrix(1024, 256, "cubic")
    )


def test_resize_identity_shortcut_and_batch():
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, size=(2, 48, 96, 3)).astype(np.uint8)
    same = tresize.resize(torch.from_numpy(frames), (48, 96))
    np.testing.assert_array_equal(same.numpy(), frames.astype(np.float32))
    batch = tresize.resize(torch.from_numpy(frames), (24, 48))
    for i in range(2):
        np.testing.assert_allclose(
            batch[i].numpy(),
            np.asarray(jresize.resize(jnp.asarray(frames[i]), (24, 48))),
            rtol=0, atol=2e-4,  # float32 summation order only
        )


def test_segmentation_overlay_matches_jax():
    rng = np.random.default_rng(4)
    frame = rng.uniform(0, 255, size=(32, 64, 3)).astype(np.float32)
    road = rng.random((32, 64)) < 0.5
    fence = rng.random((32, 64)) < 0.3  # overlaps road: the paste-order case
    seg = tconfig.SegmenterConfig()
    want = np.asarray(joverlay.segmentation_overlay(
        jnp.asarray(frame), jnp.asarray(road), jnp.asarray(fence), seg.road_rgba, seg.fence_rgba))
    got = toverlay.segmentation_overlay(
        torch.from_numpy(frame), torch.from_numpy(road), torch.from_numpy(fence),
        seg.road_rgba, seg.fence_rgba).numpy()
    # elementwise float32 with a round after each paste: bit-equal
    np.testing.assert_array_equal(got, want)
    gray_want = np.asarray(joverlay.rgb_to_gray(jnp.asarray(frame)))
    gray_got = toverlay.rgb_to_gray(torch.from_numpy(frame)).numpy()
    assert np.abs(gray_got - gray_want).max() <= 1.0  # a 3-term dot, rounded
