"""The plain reference against the port's CPU path on tiny networks (1/16 of
the channels, fc 32), and the measurement path without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT, tiny_config
from portbench.harness import cell as cell_lib
from portbench.harness import scenes, setup
from portbench.reference import frame as ref_frame
from portbench.reference import geometry


def _port_pipeline(c, weights):
    from semantic_depth_tpu_torch.pipeline import SemanticDepthPipeline

    fcn, mono = setup._port_networks(c, weights, torch.device("cpu"))
    return SemanticDepthPipeline(cell_lib.port_config(c), fcn, mono, device="cpu")


def _frames(c, n, seed, scale=2):
    gen = torch.Generator().manual_seed(seed)
    h, w = c["input_height"] * scale, c["input_width"] * scale
    return scenes.render_pool(scenes.pool_params(n, gen), h, w, c["camera"], gen)[0]


@pytest.mark.parametrize("name", ["munich-bf16", "native-bf16"])
def test_networks_agree_in_float32(name):
    """Resize, masks and the scaled disparity (flip blend included) of the
    port in float32 against the reference's, on the same weights."""
    from semantic_depth_tpu_torch import pipeline as port

    c = tiny_config(name)
    c["compute_dtype"] = "float32"
    weights = setup.make_weights(c, torch.Generator().manual_seed(4))
    pipe = _port_pipeline(c, weights)
    frames = _frames(c, 2, 5, 1 if c["networks"]["fcn8s"]["input_s2d"] else 2)
    with torch.inference_mode():
        small, road, fence = pipe._batch_segment(frames)
        cam, s_w = port._scaled_camera(pipe.config, port._scalar(380.0))
        disp = pipe._batch_disparity(small, port._scalar(250.0) * s_w)
    ref = ref_frame.networks(frames, c, 250.0, weights)
    assert torch.equal(small, ref["small"])
    assert torch.equal(road, ref["road_mask"]) and torch.equal(fence, ref["fence_mask"])
    assert road.all()  # the calibration's +2 road bias
    torch.testing.assert_close(disp, ref["disparity"], rtol=2e-5, atol=0)


def test_tail_agrees_on_the_same_inputs():
    """The geometry tail on the stand-in scenes: the same kept slots, road
    and fence planes, distances and overlay as the port's."""
    from semantic_depth_tpu_torch import pipeline as port

    c = tiny_config("munich-bf16", scenes=True)
    gen = torch.Generator().manual_seed(6)
    params = scenes.pool_params(2, gen)
    _, labels, disp_norm, rw, f2f = scenes.render_pool(params, 256, 512, c["camera"], gen,
                                                       image=False)
    small = torch.rand((2, 256, 512, 3), generator=gen) * 255
    road, fence = labels == scenes.ROAD, labels == scenes.FENCE
    disp = disp_norm * 2048.0
    pipe = port.SemanticDepthPipeline(cell_lib.port_config(c), torch.nn.Identity(),
                                      torch.nn.Identity(), device="cpu")
    cam, _ = port._scaled_camera(pipe.config, port._scalar(380.0))
    with torch.inference_mode():
        out = pipe._batch_geometry(small, road, fence, disp, cam)
    ref = ref_frame.tail(disp, road, fence, c, 380.0, c["depth"])
    assert int(out.road_cloud.valid.sum()) > 500
    assert torch.equal(out.road_cloud.valid, ref["keep"])
    torch.testing.assert_close(out.dist_rw, ref["dist_rw"], rtol=1e-6, atol=0)
    torch.testing.assert_close(out.dist_f2f, ref["dist_f2f"], rtol=1e-5, atol=0)
    for key in ("road_plane", "fence_left_plane", "fence_right_plane"):
        torch.testing.assert_close(getattr(out, key), ref[key], rtol=1e-4, atol=1e-5)
    assert torch.equal(out.overlay_small, ref_frame.overlay(small, road, fence, c))
    assert (ref["dist_f2f"].double() - torch.tensor(f2f, dtype=torch.float64)).abs().max() < 1e-3


def test_resize_is_opencv_cubic():
    """The reference's matrix reproduces an integer-factor cubic resize of a
    constant image exactly, and its rows sum to one."""
    m = geometry.cubic_matrix(1024, 256)
    assert m.shape == (256, 1024)
    torch.testing.assert_close(torch.from_numpy(m).sum(1), torch.ones(256))
    flat = torch.full((1, 16, 16, 3), 77.0)
    assert torch.equal(geometry.resize_u8(flat, (4, 4)), torch.full((1, 4, 4, 3), 77.0))


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints nothing on stdout;
    in a directory that holds only the benchmark it does the same."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cmd = [sys.executable, "portbench/run.py", "--workload", "munich-bf16.batch8", "--seed",
           str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"]
    env = dict(os.environ, PYTHONPATH="")
    done = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert done.returncode != 0 and done.stdout == ""
    assert "CUDA device" in done.stderr
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    done = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, env=env,
                          timeout=300)
    assert done.returncode != 0 and done.stdout == ""


def test_traffic_files_are_data():
    for path in sorted((BENCH / "traffic").iterdir()):
        assert path.suffix == ".json"
        t = json.loads(path.read_text())
        assert t["name"] == path.stem and t["pool"] % t["batch"] == 0
