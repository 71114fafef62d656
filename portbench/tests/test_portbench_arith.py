"""The arithmetic frozen with the benchmark, each against a count made
another way or worked by hand."""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import BENCH
from portbench.harness import bounds, scenes, setup
from portbench.harness.standins import SceneFCN, SceneMono
from portbench.reference import nets


def _meta_weights(layers):
    out = {}
    for layer in layers:
        out[f"{layer.name}.weight"] = torch.empty(layer.weight_shape, device="meta")
        out[f"{layer.name}.bias"] = torch.empty(layer.cout, device="meta")
    return out


@pytest.mark.parametrize("name,total", [("munich-bf16", 170.7), ("native-bf16", 591.8)])
def test_network_flop_per_frame(name, total):
    """The configuration's network GFLOP a frame equals the flop counter's
    count on the meta device, of the reference's networks and of the port's."""
    from semantic_depth_tpu_torch.models import FCN8s, Monodepth

    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    net = c["networks"]
    s2d, flip = net["fcn8s"]["input_s2d"], net["monodepth"]["flip_average"]
    x = torch.empty((1, c["input_height"], c["input_width"], 3), device="meta")
    with FlopCounterMode(display=False) as fc:
        nets.fcn_logits(_meta_weights(nets.fcn_layers(3, s2d)), x, s2d)
    fcn = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        nets.mono_disparity(_meta_weights(nets.mono_layers(s2d)), x, s2d)
    mono = fc.get_total_flops() * (2 if flip else 1)
    assert fcn / 1e9 == pytest.approx(c["network_gflop_per_frame"]["fcn8s"], rel=1e-9)
    assert mono / 1e9 == pytest.approx(c["network_gflop_per_frame"]["monodepth"], rel=1e-9)
    assert (fcn + mono) / 1e9 == pytest.approx(total, abs=0.05)
    with torch.device("meta"):
        port_fcn, port_mono = FCN8s(input_s2d=s2d), Monodepth(input_s2d=s2d)
    with FlopCounterMode(display=False) as fc:
        port_fcn(x)
        port_mono.disp_left(x)
    assert fc.get_total_flops() == fcn + mono // (2 if flip else 1)


def test_bound_ms_by_hand():
    assert bounds.bound_ms(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert bounds.bound_ms(0, 67e9) == (pytest.approx(1.0), "operations")
    assert bounds.mad_work(10) == (60, 370.0)
    assert bounds.resize_flop((1024, 2048), (256, 512)) == 2 * 256 * 1024 * 2048 * 3 + \
        2 * 256 * 3 * 2048 * 512
    assert bounds.resize_flop((1024, 2048), (1024, 2048)) == 0.0


def test_knn_grid_work_by_hand():
    """One row of 5 valid pixels, window (1, 3), k = 2: the candidates of
    each pixel are 2, 3, 3, 3, 2 (13 pairs at 9 operations), and all five
    have k of them (5 at 2k + 1 = 5)."""
    valid = torch.ones((1, 1, 5), dtype=torch.bool)
    n_bytes, n_ops = bounds.knn_grid_work(valid, k=2, window=(1, 3))
    assert n_bytes == 5 * 17 and n_ops == 13 * 9 + 5 * 5
    valid[0, 0, 2] = False  # the four left: 2 candidates each, self included
    n_bytes, n_ops = bounds.knn_grid_work(valid, k=2, window=(1, 3))
    assert n_ops == 8 * 9 + 4 * 5
    n_bytes, n_ops = bounds.knn_grid_work(valid, k=3, window=(1, 3))
    assert n_ops == 8 * 9


def test_radius_pairs_by_hand():
    """Two points 0.1 m apart and one 10 m away: each near point pairs with
    both near ones, the far one with itself: 5 pairs; an invalid point adds none."""
    xyz = torch.tensor([[[0.0, 0.0, -10.0], [0.0, 0.0, -10.1], [0.0, 0.0, -20.0],
                         [0.0, 0.0, -10.05]]])
    valid = torch.tensor([[True, True, True, False]])
    assert bounds.radius_pairs(xyz, valid, 0.5) == 5.0
    assert bounds.radius_work(xyz, valid, 0.5) == (4 * 21, 50.0)


def test_kernel_names():
    assert bounds.kernel_of("void knn_grid_kernel<10, 5, 21>(float const*, bool const*)") == "K1"
    assert bounds.kernel_of("knn_grid_general_kernel(GeneralArgs)") == "K1"
    assert bounds.kernel_of("mad_cluster_kernel(float const*, bool const*, ...)") == "K2"
    assert bounds.kernel_of("radius_prep_kernel(float const*)") == "K3"
    assert bounds.kernel_of("radius_kernel") == "K3"
    assert bounds.kernel_of("void at::native::vectorized_elementwise_kernel<4>") is None


def test_scene_copy_matches_the_ports_generator():
    """The device copy renders the port's scenes: the same labels, and the
    same disparity without noise, for the same parameters."""
    from semantic_depth_tpu_torch.config import CAMERA_MUNICH
    from semantic_depth_tpu_torch.utils import bench_scenes as port

    cam = dict(cx=CAMERA_MUNICH.cx, cy=CAMERA_MUNICH.cy, baseline=CAMERA_MUNICH.baseline,
               focal=CAMERA_MUNICH.focal)
    p = scenes.SceneParams(road_width=3.9, cam_height=1.5, fence_x=3.4, fence_height=2.1,
                           center_jitter=0.12)
    q = port.SceneParams(3.9, 1.5, 3.4, 2.1, 0.12)
    gen = torch.Generator().manual_seed(0)
    for h, w in ((256, 512), (512, 1024)):
        _, labels, disp, rw, f2f = scenes.render(p, h, w, cam, gen, disp_noise=0.0)
        _, want_l, want_d, want_rw, want_f2f = port.render_scene(
            np.random.default_rng(0), h, w, params=q, disp_noise=0.0)
        assert np.array_equal(labels.numpy(), want_l)
        np.testing.assert_allclose(disp.numpy(), want_d, rtol=1e-6)
        assert (rw, f2f) == (want_rw, want_f2f)
        assert (labels == scenes.ROAD).sum() > 1000 and (labels == scenes.FENCE).sum() > 1000


def test_pool_params_are_one_set_in_a_seeded_order():
    a = scenes.pool_params(16, torch.Generator().manual_seed(1))
    b = scenes.pool_params(16, torch.Generator().manual_seed(2))
    key = lambda p: (p.road_width, p.fence_x)  # noqa: E731
    assert sorted(a, key=key) == sorted(b, key=key) and a != b
    assert len({p.road_width for p in a}) == 16


def test_standins_return_the_scenes():
    labels = torch.tensor([[[7, 13], [22, 7]]], dtype=torch.uint8)
    logits = SceneFCN(labels)(torch.zeros((1, 2, 2, 3)))
    assert torch.equal(logits.argmax(-1), torch.tensor([[[0, 1], [2, 0]]]))
    assert float(logits.max()) == 8.0
    disp = torch.rand((2, 3, 4))
    mono = SceneMono(disp, flip=True)
    out = mono.disp_left(torch.zeros((4, 3, 4, 3)))
    assert torch.equal(out[:2], disp) and torch.equal(out[2:].flip(-1), disp)


@pytest.mark.parametrize("name", ["munich-bf16", "native-bf16"])
def test_calibration_bias_on_every_road_phase(name):
    """``measurable``'s +2 road-logit bias lands on the road channel of
    every pixel phase of ``upscore8`` (phase-major: (di * 2 + dj) * C + c)."""
    from conftest import tiny_config

    c = tiny_config(name)
    w = setup.make_weights(c, torch.Generator().manual_seed(3))
    bias = w["fcn"]["upscore8.bias"].float()
    phases = 4 if c["networks"]["fcn8s"]["input_s2d"] else 1
    assert bias.shape == (3 * phases,)
    assert torch.equal(bias, torch.tensor([2.0, 0.0, 0.0] * phases))


def test_upload_rate_is_read_where_frames_are_on_the_host():
    from portbench.metrics import upload_gbps

    assert upload_gbps.read(dict(stages=dict(tail_ms=1.0, upload_gbps=7.5))) == 7.5
    assert upload_gbps.read(dict(stages=dict(tail_ms=1.0))) is None
