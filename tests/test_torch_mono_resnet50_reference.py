"""Monodepth with the ResNet-50 encoder: the port's ``Monodepth("resnet50")``
against the benchmark's plain reference (``portbench/reference/
mono_resnet50.py``, written from Godard et al. 2017 and the published
``build_resnet50``) on the same seeded weights, in float32 on the CPU; the
same comparison failing on three planted faults; the configuration's FLOP
count and its port configuration."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import weights as weight_lib
from portbench.harness.cell import port_config
from portbench.reference import mono_resnet50 as ref
from portbench.reference import nets
from semantic_depth_tpu_torch import config as pc
from semantic_depth_tpu_torch.cli.common import apply_encoder_override
from semantic_depth_tpu_torch.models import Monodepth, spatial

torch.set_num_threads(2)  # six xdist workers share the machine

CONFIG = Path(__file__).resolve().parents[1] / "portbench/configs/munich-resnet50-bf16.json"
# Both sides run the same float32 convolutions, which oneDNN may sum in
# another order where the port hands them another memory layout or another
# torch picks another algorithm: a few ulp a layer through its 81 convolutions,
# far under 1e-5 of disparities of 0.08-0.3. Each fault below moves the
# disparity by 4e-3 or more.
RTOL = 1e-5


def _port(weights, input_s2d, width):
    with torch.device("meta"):
        net = Monodepth("resnet50", input_s2d=input_s2d, width_mult=width)
    net.load_state_dict({k: v.clone() for k, v in weights.items()}, assign=True)
    return net.eval()


def _case(input_s2d, width, height, seed=3):
    gen = torch.Generator().manual_seed(seed)
    weights = weight_lib.make(ref.layers(input_s2d, width), gen, torch.float32)
    images = torch.rand((2, height, 2 * height, 3), generator=gen)
    return weights, images


def _gap(port_disp, ref_disp):
    return float(((port_disp - ref_disp).abs() / ref_disp.abs()).max())


# full widths at the smallest size whose bottom (H/64 of the trunk's grid;
# input_s2d halves that grid first) is whole, and width 1/16 at 128x256
CASES = [(False, 1.0, 64), (True, 1.0, 128), (False, 0.0625, 128), (True, 0.0625, 128)]


@pytest.mark.parametrize("input_s2d,width,height", CASES,
                         ids=["plain-full", "s2d-full", "plain-sixteenth", "s2d-sixteenth"])
def test_port_matches_the_reference_in_float32(input_s2d, width, height):
    weights, images = _case(input_s2d, width, height)
    with torch.inference_mode():
        got = _port(weights, input_s2d, width).disp_left(images)
        want = ref.disparity(weights, images, input_s2d)
    assert got.shape == want.shape == images.shape[:3] and want.dtype == torch.float32
    assert 0.0 < float(want.min()) and float(want.max()) < 0.3  # no saturated sigmoid
    torch.testing.assert_close(got, want, rtol=RTOL, atol=0)


def _inf_padded_pool(x, rows):
    return F.max_pool2d(F.pad(x, (1, 1, 1, 1), value=float("-inf")), 3, 2)


def _drop_res4_shortcut(net, monkeypatch):
    with torch.no_grad():
        net.res4_2_sc.weight.zero_()
        net.res4_2_sc.bias.zero_()


def _stride_on_first_block(net, monkeypatch):
    """Each stage strides in its first block (c2 and the shortcut) instead
    of its last, as torchvision's ResNet-50 does."""
    for stage, (_, blocks) in enumerate(ref.STAGES, start=2):
        for part in ("c2", "sc"):
            getattr(net, f"res{stage}_0_{part}").stride = (2, 2)
            getattr(net, f"res{stage}_{blocks - 1}_{part}").stride = (1, 1)


def _stem_pool_minus_inf(net, monkeypatch):
    monkeypatch.setattr(spatial, "max_pool3_zero_padded", _inf_padded_pool)


@pytest.mark.parametrize("fault", [_stem_pool_minus_inf, _drop_res4_shortcut,
                                   _stride_on_first_block],
                         ids=["stem-pool-minus-inf", "res4-shortcut-dropped",
                              "stride-on-first-block"])
def test_a_faulty_port_fails_the_tolerance(fault, monkeypatch):
    weights, images = _case(False, 1.0, 64)
    net = _port(weights, False, 1.0)
    fault(net, monkeypatch)
    with torch.inference_mode():
        got = net.disp_left(images)
        want = ref.disparity(weights, images)
    assert _gap(got, want) > 100 * RTOL


def _meta_weights(layers):
    return {k: torch.empty(shape, device="meta") for layer in layers
            for k, shape in ((f"{layer.name}.weight", layer.weight_shape),
                             (f"{layer.name}.bias", (layer.cout,)))}


def test_configuration_flop_is_the_meta_device_count():
    """The flip pair at 256x512: the reference's and the port's FLOP on the
    meta device, against ``network_gflop_per_frame.monodepth``."""
    c = json.loads(CONFIG.read_text())
    assert c["networks"]["monodepth"] == dict(encoder="resnet50", input_s2d=False,
                                              flip_average=True)
    x = torch.empty((1, c["input_height"], c["input_width"], 3), device="meta")
    with FlopCounterMode(display=False) as fc:
        ref.disparity(_meta_weights(ref.layers(False)), x)
    want = c["network_gflop_per_frame"]["monodepth"]
    assert 2 * fc.get_total_flops() / 1e9 == pytest.approx(want, rel=1e-12)
    with torch.device("meta"):
        port = Monodepth("resnet50")
    with FlopCounterMode(display=False) as fc:
        port.disp_left(x)
    assert 2 * fc.get_total_flops() / 1e9 == pytest.approx(want, rel=1e-12)
    assert sum(v.numel() for v in port.state_dict().values()) == 58_452_008


def test_configuration_is_the_munich_preset_with_resnet50():
    c = json.loads(CONFIG.read_text())
    want = apply_encoder_override(pc.munich_pipeline_config(compute_dtype="bfloat16"),
                                  "resnet50")
    assert port_config(c) == want
    assert want.monodepth.encoder == "resnet50"
    munich = json.loads(CONFIG.with_name("munich-bf16.json").read_text())
    assert port_config(munich) == dataclasses.replace(
        want, monodepth=dataclasses.replace(want.monodepth, encoder="vgg"))
    assert nets.network("mono", "resnet50") is ref
