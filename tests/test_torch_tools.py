"""The port's remaining single-device tools against the JAX package's on the
CPU: ``cli.monodepth_infer``, ``cli.segment_video``, ``utils.render_ply``,
``utils.video``, ``runtime.trace`` / ``annotate``, and the pipeline's public
per-frame ``segment`` / ``disparity``."""

import json

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from semantic_depth_tpu import config as jconfig
from semantic_depth_tpu import pipeline as jpipeline
from semantic_depth_tpu.cli import monodepth_infer as jinfer
from semantic_depth_tpu.cli import segment_video as jsegvid
from semantic_depth_tpu.models import FCN8s as JaxFCN8s
from semantic_depth_tpu.models import Monodepth as JaxMonodepth
from semantic_depth_tpu.utils import render_ply as jrender
from semantic_depth_tpu_torch import config as tconfig
from semantic_depth_tpu_torch import pipeline as tpipeline
from semantic_depth_tpu_torch import runtime
from semantic_depth_tpu_torch.cli import monodepth_infer as tinfer
from semantic_depth_tpu_torch.cli import segment_video as tsegvid
from semantic_depth_tpu_torch.models import FCN8s, Monodepth
from semantic_depth_tpu_torch.models.from_flax import load_flax
from semantic_depth_tpu_torch.utils import render_ply as trender
from semantic_depth_tpu_torch.utils.video import create_video_from_frames

from torch_helpers import numpy_params

torch.set_num_threads(2)  # six xdist workers share the machine


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """Tiny FCN-8s and monodepth parameters (numpy-seeded), as msgpack files
    and as flax trees."""
    root = tmp_path_factory.mktemp("tools")
    x = np.zeros((1, 128, 256, 3), np.float32)
    jfcn = JaxFCN8s(num_classes=3, width_mult=0.0625, fc_channels=32)
    jmono = JaxMonodepth("vgg", width_mult=0.0625)
    params = dict(fcn=numpy_params(jfcn, x, seed=0), mono=numpy_params(jmono, x, seed=1))
    paths = {}
    for name, tree in params.items():
        paths[name] = str(root / f"{name}.msgpack")
        with open(paths[name], "wb") as f:
            f.write(serialization.to_bytes(tree))
    return dict(root=root, jfcn=jfcn, jmono=jmono, params=params, paths=paths)


def _noise_pngs(d, n, seed):
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (96, 192, 3)).astype(np.uint8)).save(
            d / f"f_{i}.png")
    return d


def test_monodepth_infer_matches_jax(tmp_path, nets):
    frames = _noise_pngs(tmp_path / "frames", 3, seed=0)
    args = ["--input", str(frames / "*.png"), "--monodepth_checkpoint", nets["paths"]["mono"],
            "--input_height", "128", "--input_width", "256", "--dev_tiny", "--save_npy",
            "--batch", "2"]
    jinfer.main(args + ["--out_dir", str(tmp_path / "jax")])
    tinfer.main(args + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    for i in range(3):
        want = np.load(tmp_path / "jax" / f"f_{i}_disp.npy")
        got = np.load(tmp_path / "port" / f"f_{i}_disp.npy")
        assert got.shape == want.shape == (128, 256) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        png = np.asarray(Image.open(tmp_path / "port" / f"f_{i}_disp.png"))
        assert png.shape == (96, 192, 4)


def _frames(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame.astype(np.float64))
    cap.release()
    return out


def test_segment_video_matches_jax(tmp_path, nets):
    rng = np.random.default_rng(3)
    vid = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 10, (192, 96))
    for _ in range(5):
        w.write(rng.integers(0, 255, (96, 192, 3)).astype(np.uint8))
    w.release()
    args = ["--input_video", vid, "--semantic_model", nets["paths"]["fcn"], "--input_height",
            "128", "--input_width", "256", "--batch", "2", "--dev_tiny"]
    jsegvid.main(args + ["--output_video", str(tmp_path / "jax.mp4")])
    assert tsegvid.main(args + ["--output_video", str(tmp_path / "port.mp4"),
                                "--device", "cpu"]) == 5
    want, got = _frames(tmp_path / "jax.mp4"), _frames(tmp_path / "port.mp4")
    assert len(got) == len(want) == 5
    # the same overlays through the same lossy encoder: a resize rounding or
    # a mask pixel on 0.5 may differ (ROADMAP section C)
    for g, wnt in zip(got, want):
        assert np.abs(g - wnt).mean() < 0.5


def _one_point_per_pixel(h, w, focal, seed):
    """Points that project to distinct pixels of an (h, w) image, some
    behind the camera and some outside it, camera at the origin."""
    rng = np.random.default_rng(seed)
    vs, us = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    keep = rng.random((h, w)) < 0.6
    u, v = us[keep].astype(np.float64), vs[keep].astype(np.float64)
    z = rng.uniform(1.0, 40.0, u.shape)
    pts = np.stack([(u - w / 2.0) * z / focal, -(v - h / 2.0) * z / focal, -z], -1)
    extra = np.array([[0.0, 0.0, 5.0], [1e4, 0.0, -1.0], [0.0, 0.0, -0.05]])
    pts = np.concatenate([pts, extra]).astype(np.float32)
    cols = rng.integers(0, 256, (len(pts), 3)).astype(np.float32)
    return pts, cols


@pytest.mark.parametrize("splat", [1, 2])
def test_render_points_matches_jax(splat):
    pts, cols = _one_point_per_pixel(48, 96, 60.0, seed=splat)
    kw = dict(image_hw=(48, 96), focal=60.0, camera_pos=np.zeros(3), splat=splat)
    want = jrender.render_points(pts, cols, **kw)
    got = trender.render_points(pts, cols, device="cpu", **kw)
    assert got.dtype == np.uint8 and got.shape == (48, 96, 3)
    assert (got != 255).any(-1).mean() > 0.5
    np.testing.assert_array_equal(got, want)


def test_render_keeps_the_nearest_and_writes_the_imsave_png(tmp_path):
    """Two points on one pixel: the near one wins; the PNG is RGBA with
    alpha 255, as plt.imsave writes an RGB image."""
    from semantic_depth_tpu_torch.io.ply import write_ply

    pts = np.array([[0.0, 0.5, -5.0], [0.0, 0.5, -20.0], [0.0, 0.5, -30.0]])
    cols = np.array([[0.0, 255.0, 0.0], [255.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    img = trender.render_points(pts[:2], cols[:2], image_hw=(64, 64), focal=50.0, splat=1,
                                device="cpu")
    (y, x), = np.argwhere(np.any(img != 255, axis=-1))
    assert img[y, x].tolist() == [0, 255, 0]
    # the PLY's infinity filter drops the farthest point (z at the minimum)
    ply = write_ply(pts, cols, str(tmp_path / "c"))
    png = trender.render_ply_file(ply, str(tmp_path / "c.png"), image_hw=(64, 64), focal=50.0,
                                  splat=1, device="cpu")
    rgba = np.asarray(Image.open(png))
    assert rgba.shape == (64, 64, 4) and (rgba[..., 3] == 255).all()
    np.testing.assert_array_equal(rgba[..., :3], img)


def test_create_video_from_frames(tmp_path):
    frames = _noise_pngs(tmp_path / "frames", 4, seed=2)
    cv2.imwrite(str(frames / "f_9.png"), np.zeros((48, 96, 3), np.uint8))  # resized to fit
    out = create_video_from_frames(str(frames / "*.png"), str(tmp_path / "v.mp4"), fps=5)
    got = _frames(out)
    assert len(got) == 5 and got[0].shape == (96, 192, 3)


def test_trace_writes_a_trace_with_the_annotated_span(tmp_path):
    with runtime.trace(str(tmp_path / "trace")) as tr:
        with runtime.annotate("sd_smoke_span"):
            torch.arange(16.0).sum()
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "sd_smoke_span" for e in events)


def test_segment_and_disparity_match_jax(nets):
    jcfg = jconfig.munich_pipeline_config(input_height=128, input_width=256)
    jpipe = jpipeline.SemanticDepthPipeline(jcfg, nets["params"]["fcn"], nets["params"]["mono"],
                                            fcn=nets["jfcn"], mono=nets["jmono"])
    tpipe = tpipeline.SemanticDepthPipeline(
        tconfig.munich_pipeline_config(input_height=128, input_width=256),
        load_flax(FCN8s(num_classes=3, width_mult=0.0625, fc_channels=32), nets["params"]["fcn"]),
        load_flax(Monodepth("vgg", width_mult=0.0625), nets["params"]["mono"]), device="cpu")
    small = np.round(np.random.default_rng(5).uniform(0, 255, (128, 256, 3))).astype(np.float32)
    jroad, jfence, jprobs = jpipe.segment(nets["params"]["fcn"], jnp.asarray(small))
    road, fence, probs = tpipe.segment(small)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=1e-5)
    for got, want in ((road, jroad), (fence, jfence)):
        assert (got.numpy() != np.asarray(want)).mean() < 1e-3  # a pixel on 0.5 may flip
    want = jpipe.disparity(nets["params"]["mono"], jnp.asarray(small), jnp.float32(96.0))
    got = tpipe.disparity(small, 96.0)
    assert got.shape == (128, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)
