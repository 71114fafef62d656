"""The port's program tracing (``runtime.tracing``, ``annotate``, ``stats``)
on the CPU: off, a span is one shared null context and the program leaves
no ``sd.*`` event in an outer profile; on, the spans nest as the pipeline
opens them and ``stats`` counts them by name, each with the call id of its
``sd.call``; ``trace`` turns tracing on inside its block."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from semantic_depth_tpu_torch import config, pipeline, runtime
from semantic_depth_tpu_torch.models import FCN8s, Monodepth

torch.set_num_threads(2)  # six xdist workers share the machine

# the tree the pipeline opens on one process_batch of the munich preset
PARENT = {"sd.upload": "sd.call", "sd.networks": "sd.call", "sd.tail": "sd.call",
          "sd.resize": "sd.networks", "sd.fcn": "sd.networks", "sd.monodepth": "sd.networks",
          "sd.mono.encoder": "sd.monodepth", "sd.mono.decoder": "sd.monodepth",
          "sd.road": "sd.tail", "sd.fence": "sd.tail", "sd.overlay": "sd.tail",
          "sd.k1": "sd.road", "sd.k3": "sd.road"}


@pytest.fixture(scope="module")
def pipe():
    torch.manual_seed(0)
    cfg = config.munich_pipeline_config(input_height=128, input_width=256)
    assert cfg.approach == "both" and cfg.road.stat_mode == "grid"
    return pipeline.SemanticDepthPipeline(
        cfg, FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625),
        device="cpu")


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (1, 96, 192, 3)).astype(np.uint8)


def _sd_events(prof):
    return sorted(((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("sd.")), key=lambda s: (s[0], -s[1]))


def test_off_annotate_is_one_shared_null_context_and_the_program_leaves_no_span(pipe, frames):
    assert runtime.annotate("sd.a") is runtime.annotate("sd.b", True)
    runtime.stats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.process_batch(frames)
    assert _sd_events(prof) == []
    assert runtime.stats() == {}


def test_on_spans_nest_as_the_pipeline_opens_them(pipe, frames):
    with profile(activities=[ProfilerActivity.CPU]) as prof, runtime.tracing():
        pipe.process_batch(frames)
    runtime.stats()
    spans = _sd_events(prof)
    parents = []
    for s, e, name in spans:
        outer = [o for o in spans if o[0] <= s and e <= o[1] and o != (s, e, name)]
        inner = max(outer, key=lambda o: (o[0], -o[1]), default=None)
        parents.append((name, inner and inner[2]))
    assert Counter(parents) == Counter(
        [("sd.call", None)] + list(PARENT.items())
        + [("sd.k2", "sd.road")] * 2 + [("sd.k2", "sd.fence")] * 2)


def test_stats_counts_one_munich_batch_and_forgets_it(pipe, frames):
    with runtime.tracing():
        pipe.process_batch(frames)
        pipe.process_frame(frames[0])
    got = runtime.stats()
    assert {n: got[n]["calls"] for n in ("sd.call", "sd.k1", "sd.k2", "sd.k3")} == {
        "sd.call": 2, "sd.k1": 2, "sd.k2": 8, "sd.k3": 2}
    assert "sd.k4" not in got and set(got) == {"sd.call", "sd.k2"} | set(PARENT)
    first, second = got["sd.call"]["call_ids"]
    assert second == first + 1
    for name, row in got.items():
        assert row["call_ids"] == [first, second], name
        assert row["device_ms"] is None and row["host_ms"] > 0.0  # no card, no events
    assert got["sd.call"]["host_ms"] >= got["sd.tail"]["host_ms"]
    assert runtime.stats() == {}


def test_tracing_restores_the_state_around_it_and_trace_turns_it_on(tmp_path):
    assert not runtime._on
    with runtime.tracing():
        with runtime.tracing(False):
            assert runtime.annotate("sd.x") is runtime._NULL
        assert runtime._on
        with runtime.annotate(runtime.CALL):
            with runtime.annotate("sd.k2"):
                pass
        with runtime.annotate("sd.k2"):
            pass
    assert not runtime._on
    got = runtime.stats()
    assert got["sd.k2"]["calls"] == 2 and got["sd.k2"]["call_ids"][0] == 0  # outside a call
    with runtime.trace(str(tmp_path / "t")):
        assert runtime._on
    assert not runtime._on
