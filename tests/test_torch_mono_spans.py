"""Monodepth's own spans on the CPU: under ``runtime.tracing()`` one
``process_batch`` opens ``sd.mono.encoder`` and ``sd.mono.decoder`` once
each, inside ``sd.monodepth``, for both encoders and for DPT-Large
(``--dev_tiny``'s sizes); with tracing off
``stats()`` records none."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from semantic_depth_tpu_torch import config, pipeline, runtime
from semantic_depth_tpu_torch.cli.common import DPT_TINY, apply_encoder_override
from semantic_depth_tpu_torch.models import DPT, FCN8s, Monodepth

torch.set_num_threads(2)  # six xdist workers share the machine

MONO = ("sd.mono.encoder", "sd.mono.decoder")


@pytest.fixture(scope="module", params=["vgg", "resnet50", "dpt_large"])
def pipe(request):
    torch.manual_seed(0)
    cfg = apply_encoder_override(config.munich_pipeline_config(input_height=128,
                                                               input_width=256), request.param)
    if request.param == "dpt_large":
        mono = DPT(**DPT_TINY, shift=0.04)
    else:
        mono = Monodepth(encoder=request.param, width_mult=0.0625)
    return pipeline.SemanticDepthPipeline(cfg, FCN8s(width_mult=0.0625, fc_channels=32), mono,
                                          device="cpu")


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (1, 96, 192, 3)).astype(np.uint8)


def test_encoder_and_decoder_open_once_inside_monodepth(pipe, frames):
    with profile(activities=[ProfilerActivity.CPU]) as prof, runtime.tracing():
        pipe.process_batch(frames)
    got = runtime.stats()
    assert {n: got[n]["calls"] for n in MONO + ("sd.monodepth",)} == dict.fromkeys(
        MONO + ("sd.monodepth",), 1)
    spans = {e.name(): (e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.name() in MONO + ("sd.monodepth",)}
    outer = spans["sd.monodepth"]
    enc, dec = spans["sd.mono.encoder"], spans["sd.mono.decoder"]
    assert outer[0] <= enc[0] < enc[1] <= dec[0] < dec[1] <= outer[1]


def test_off_the_encoder_and_decoder_record_nothing(pipe, frames):
    runtime.stats()
    pipe.process_batch(frames)
    assert runtime.stats() == {}
