"""DPT-Large as the depth network: the port's ``models.DPT`` against the
benchmark's plain reference (``portbench/reference/mono_dpt_large.py``,
written from Ranftl et al. 2021 and isl-org/DPT) on the same seeded
weights, in float32 on the CPU at a small size; the same comparison
failing on five planted faults; the published widths' parameters, the
configuration's FLOP count and the attention roofline's FLOP function on
the meta device; the ``sdpa`` counter; and a tiny pipeline with the flip
batch."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import weights as weight_lib
from portbench.harness.cell import port_config
from portbench.metrics import attention_roofline
from portbench.reference import mono_dpt_large as ref
from portbench.reference import nets
from semantic_depth_tpu_torch import config as pc
from semantic_depth_tpu_torch import pipeline, runtime
from semantic_depth_tpu_torch.cli import common
from semantic_depth_tpu_torch.models import DPT, FCN8s, dpt

torch.set_num_threads(2)  # six xdist workers share the machine

CONFIG = Path(__file__).resolve().parents[1] / "portbench/configs/munich-dpt-large-bf16.json"
SMALL = dict(width=64, layers=4, heads=2, mlp=256, patch=16, pos_grid=3, hooks=[0, 1, 2, 3],
             neck=[16, 32, 64, 64], features=16, head_hidden=8, eps=1e-6, scale=1.0, shift=0.04)
# Both sides compute in float32, but the port's attention is one
# F.scaled_dot_product_attention (the CPU's flash kernel, an online softmax
# summed block by block) where the reference takes two matmuls and a
# softmax: another order of summation, a few ulp a block through 4 blocks
# and the decoder: under 4e-5 of the disparity on nine seeds, most where the
# head's features are near zero (the shift keeps such pixels off zero).
# Each fault below moves the disparity by 5e-2 or more of it.
RTOL = 1e-4


def _case(seed=3, h=64):
    gen = torch.Generator().manual_seed(seed)
    weights = weight_lib.make_params(ref.params(SMALL), gen, torch.float32)
    images = torch.rand((2, h, 2 * h, 3), generator=gen)
    return weights, images


def _port(weights):
    with torch.device("meta"):
        net = DPT(**SMALL)
    net.load_state_dict({k: v.clone() for k, v in weights.items()}, assign=True)
    return net.eval()


def _gap(got, want):
    return float(((got - want).abs() / want.abs()).max())


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_port_matches_the_reference_in_float32(seed):
    """At a 4 x 8 patch grid (64x128), the 3 x 3 position table resized."""
    weights, images = _case(seed)
    with torch.inference_mode():
        got = _port(weights).disp_left(images)
        want = ref.disparity(weights, images, SMALL)
    assert got.shape == want.shape == images.shape[:3] and got.dtype == torch.float32
    assert float(want.min()) >= float(torch.tensor(SMALL["shift"]))
    assert float(want.max()) > 4 * SMALL["shift"]
    assert _gap(got, want) <= RTOL


def _dropped_block(net, monkeypatch):
    net.blocks[1] = nn.Identity()


def _hook_off_by_one(net, monkeypatch):
    net.hooks = (0, 2, 2, 3)


def _readout_without_class_token(net, monkeypatch):
    monkeypatch.setattr(dpt, "_with_class_token",
                        lambda t: torch.cat([t[:, 1:], torch.zeros_like(t[:, 1:])], -1))


def _fusion_align_corners_false(net, monkeypatch):
    for block in net.fusion:
        block.align_corners = False


def _position_table_not_resized(net, monkeypatch):
    """The table's grid entries placed by nearest index, not interpolated."""
    def nearest(pos, grid, gh, gw):
        table = pos[:, 1:].reshape(1, grid, grid, -1).permute(0, 3, 1, 2)
        table = F.interpolate(table, size=(gh, gw), mode="nearest")
        return torch.cat([pos[:, :1], table.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], 1)
    monkeypatch.setattr(dpt, "_resize_pos", nearest)


FAULTS = [_dropped_block, _hook_off_by_one, _readout_without_class_token,
          _fusion_align_corners_false, _position_table_not_resized]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__.strip("_"))
def test_a_faulty_port_fails_the_tolerance(fault, monkeypatch):
    weights, images = _case()
    net = _port(weights)
    fault(net, monkeypatch)
    with torch.inference_mode():
        got = net.disp_left(images)
        want = ref.disparity(weights, images, SMALL)
    assert _gap(got, want) > 10 * RTOL


def _published():
    return json.loads(CONFIG.read_text())["networks"]["monodepth"]


def test_published_widths_key_set_and_parameter_count():
    """The port at its defaults (DPT-Large's published widths) has exactly
    the reference's parameters, shape for shape: 341,848,257, the deepest
    fusion block's unused first unit left out on both sides."""
    slot = _published()
    with torch.device("meta"):
        port = DPT(compute_dtype=torch.bfloat16, scale=slot["scale"], shift=slot["shift"])
    want = {p.name: p.shape for p in ref.params(slot)}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    assert sum(v.numel() for v in port.state_dict().values()) == 341_848_257
    assert not any(k.startswith("fusion.3.unit1") for k in want)
    assert all(v.dtype == torch.bfloat16 for v in port.state_dict().values())


def _meta_weights(slot):
    return {p.name: torch.empty(p.shape, device="meta") for p in ref.params(slot)}


def _counted(fn, x):
    with FlopCounterMode(display=False) as fc:
        fn(x)
    return fc.get_total_flops(), {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}


def test_configuration_flop_is_the_meta_device_count():
    """The flip pair at 256x512: the reference's and the port's FLOP on the
    meta device against ``network_gflop_per_frame.monodepth``; attention's
    products (the only batched matrix products, ``aten.bmm``, inside the
    port's ``F.scaled_dot_product_attention`` on the meta device) against
    ``attention_roofline``'s FLOP function."""
    c = json.loads(CONFIG.read_text())
    slot = c["networks"]["monodepth"]
    x = torch.empty((1, c["input_height"], c["input_width"], 3), device="meta")
    weights = _meta_weights(slot)
    ref_total, ref_ops = _counted(lambda im: ref.disparity(weights, im, slot), x)
    with torch.device("meta"):
        port = DPT(compute_dtype=torch.bfloat16, **slot["port"]["kwargs"])
    port_total, port_ops = _counted(port.disp_left, x)
    want = c["network_gflop_per_frame"]["monodepth"]
    assert 2 * ref_total / 1e9 == pytest.approx(want, rel=1e-12)
    assert port_total == ref_total and port_ops == ref_ops
    assert 2 * port_ops["aten.bmm"] == attention_roofline.attention_flop_per_frame(c)
    assert attention_roofline.attention_flop_per_frame(c) == pytest.approx(51.74e9, rel=1e-3)
    # DPT's share of the network work, as the cell's why says
    share = want / sum(c["network_gflop_per_frame"].values())
    assert 0.885 < share < 0.895


def test_configuration_is_the_munich_preset_with_dpt_large():
    c = json.loads(CONFIG.read_text())
    slot = c["networks"]["monodepth"]
    want = common.apply_encoder_override(pc.munich_pipeline_config(compute_dtype="bfloat16"),
                                         "dpt_large")
    assert port_config(c) == want and want.monodepth.encoder == "dpt_large"
    assert slot["port"]["class"] == "semantic_depth_tpu_torch.models.dpt:DPT"
    kwargs = slot["port"]["kwargs"]
    assert kwargs == {k: slot[k] for k in kwargs}
    with torch.device("meta"):
        default = DPT()
    assert {k: v for k, v in kwargs.items() if k not in ("scale", "shift")} == dict(
        width=1024, layers=24, heads=16, mlp=4096, patch=16, pos_grid=24,
        hooks=list(default.hooks), neck=[256, 512, 1024, 1024], features=256, head_hidden=32,
        eps=1e-6)
    assert common.DPT_SEEDED == dict(scale=kwargs["scale"], shift=kwargs["shift"])
    assert 0 < kwargs["shift"] and c["reduced"] == []
    assert set(c["assumed"]) >= {"eps", "scale", "shift", "input", "weights"}
    assert nets.network("mono", "dpt_large") is ref


def test_sdpa_counts_one_a_block_each_forward():
    weights, images = _case()
    net = _port(weights)
    before = runtime.launches["sdpa"]
    with torch.inference_mode():
        net.disp_left(images)
        net.disp_left(images[:1])
    assert runtime.launches["sdpa"] - before == 2 * SMALL["layers"]


def test_rows_are_refused():
    weights, images = _case()
    with pytest.raises(ValueError, match="row"):
        _port(weights).disp_left(images, rows=object())


def test_tiny_pipeline_with_the_flip_batch_runs_on_the_cpu():
    """``process_batch`` with ``--dev_tiny``'s DPT: one forward of the flip
    batch (one ``sdpa`` a block), a finite disparity no lower than the
    shift times the multiplier at the working width, and the geometry tail
    on it."""
    cfg = common.apply_encoder_override(
        pc.munich_pipeline_config(input_height=128, input_width=256), "dpt_large")
    assert cfg.monodepth.flip_average
    torch.manual_seed(1)
    mono = DPT(**common.DPT_TINY, scale=1.0, shift=0.04)
    pipe = pipeline.SemanticDepthPipeline(cfg, FCN8s(width_mult=0.0625, fc_channels=32), mono,
                                          device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (2, 256, 512, 3)).astype(np.uint8)
    before = runtime.launches["sdpa"]
    out = pipe.process_batch(frames, disparity_mult=250.0)
    assert runtime.launches["sdpa"] - before == common.DPT_TINY["layers"]
    assert out.disparity.shape == (2, 128, 256) and bool(torch.isfinite(out.disparity).all())
    s_w = pipeline._scaled_camera(cfg, 1.0)[1]
    assert float(out.disparity.min()) >= 0.04 * 250.0 * s_w * (1 - 1e-6)
    assert float(out.disparity.max()) > 2 * 0.04 * 250.0 * s_w
    assert out.dist_rw.shape == (2,)
