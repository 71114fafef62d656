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


def _matrix_key(src, dst, method="cubic"):
    return (src, dst, method, torch.device("cpu"))


def test_resize_matrices_are_built_once_a_key_and_reused():
    """Sizes no other test resizes, so the first call builds both keys."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, size=(2, 37, 71, 3)).astype(np.float32))
    before = tresize.matrices.copy()
    first = tresize.resize(x, (19, 29))
    assert tresize.matrices - before == {"built": 2}
    rows, cols = (tresize._MATRICES[_matrix_key(37, 19)], tresize._MATRICES[_matrix_key(71, 29)])
    for mat, (src, dst) in ((rows, (37, 19)), (cols, (71, 29))):
        assert mat.dtype == torch.float32 and not mat.is_inference()
        assert torch.equal(mat, torch.from_numpy(tresize._interp_matrix(src, dst, "cubic")))
        assert tresize._device_matrix(src, dst, "cubic", torch.device("cpu")) is mat
    before = tresize.matrices.copy()
    again = tresize.resize(x, (19, 29))
    assert tresize.matrices - before == {"reused": 2}
    assert tresize._MATRICES[_matrix_key(37, 19)] is rows
    assert tresize._MATRICES[_matrix_key(71, 29)] is cols
    assert torch.equal(again, first)
    # a new target width takes a key for the columns; a new source height for the rows
    before = tresize.matrices.copy()
    tresize.resize(x, (19, 30))
    assert tresize.matrices - before == {"built": 1, "reused": 1}
    before = tresize.matrices.copy()
    tresize.resize(x[:, :36], (19, 29))
    assert tresize.matrices - before == {"built": 1, "reused": 1}
    assert _matrix_key(36, 19) in tresize._MATRICES and _matrix_key(71, 30) in tresize._MATRICES


def test_resize_matrix_while_tracing_is_fresh_and_uncounted(monkeypatch):
    key = _matrix_key(41, 17)
    kept = tresize._device_matrix(41, 17, "cubic", torch.device("cpu"))
    n, before = len(tresize._MATRICES), tresize.matrices.copy()
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    fresh = tresize._device_matrix(41, 17, "cubic", torch.device("cpu"))
    fresh_new = tresize._device_matrix(43, 17, "cubic", torch.device("cpu"))
    monkeypatch.undo()
    assert fresh is not kept and torch.equal(fresh, kept)
    assert torch.equal(fresh_new, torch.from_numpy(tresize._interp_matrix(43, 17, "cubic")))
    assert len(tresize._MATRICES) == n and tresize._MATRICES[key] is kept
    assert tresize.matrices == before and _matrix_key(43, 17) not in tresize._MATRICES


def test_resize_while_export_traces_keeps_no_matrix():
    class M(torch.nn.Module):
        def forward(self, x):
            return tresize.resize_clip_u8(x, (13, 22))

    x = torch.from_numpy(np.random.default_rng(6).uniform(0, 255, (1, 31, 53, 3)).astype(np.float32))
    n, before = len(tresize._MATRICES), tresize.matrices.copy()
    prog = torch.export.export(M(), (x,), strict=False)
    assert len(tresize._MATRICES) == n and tresize.matrices == before
    assert _matrix_key(31, 13) not in tresize._MATRICES
    assert torch.equal(prog.module()(x), tresize.resize_clip_u8(x, (13, 22)))


def test_resize_matrix_made_in_inference_mode_serves_outside_it():
    x = torch.from_numpy(np.random.default_rng(7).uniform(0, 255, (1, 29, 47, 3)).astype(np.float32))
    with torch.inference_mode():
        inside = tresize.resize(x, (11, 23))
    assert not tresize._MATRICES[_matrix_key(29, 11)].is_inference()
    leaf = x.clone().requires_grad_(True)
    before = tresize.matrices.copy()
    out = tresize.resize(leaf, (11, 23))
    assert tresize.matrices - before == {"reused": 2}
    out.sum().backward()
    assert leaf.grad is not None and torch.equal(out.detach(), inside)


@pytest.mark.parametrize("method", ["cubic", "linear"])
def test_resize_identity_shortcut_builds_no_matrix(method):
    x = torch.zeros((1, 33, 67, 3), dtype=torch.uint8)
    n, before = len(tresize._MATRICES), tresize.matrices.copy()
    assert torch.equal(tresize.resize(x, (33, 67), method), x.float())
    assert len(tresize._MATRICES) == n and tresize.matrices == before


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
