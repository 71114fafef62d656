"""The geometry tail's CUDA graphs (``graphs``, ``pipeline._batch_geometry``)
and the frame program's device constants (``runtime.device_constant``) on
the CPU: the graph key, the cache's order, how the dispatch serves a key
(with the capture stood in for by an eager call, since the CPU captures
nothing), and that the CPU and torch.export take the eager body. The card's
half, the replays against the eager body, is in ``test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from semantic_depth_tpu_torch import config, graphs, pipeline, runtime
from semantic_depth_tpu_torch.models import FCN8s, Monodepth
from semantic_depth_tpu_torch.ops import exact_knn, knn_grid, mad, radius
from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

torch.set_num_threads(2)  # six xdist workers share the machine

H, W = 128, 256


@pytest.fixture(scope="module")
def pipe():
    torch.manual_seed(0)
    return pipeline.SemanticDepthPipeline(
        config.munich_pipeline_config(input_height=H, input_width=W),
        FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625), device="cpu")


@pytest.fixture(scope="module")
def scenes():
    """Two analytic scenes as the tail takes them: small, road, fence, disp."""
    imgs, labels, disp_norm = scene_pool(2, H, W, seed=0)[:3]
    return [torch.from_numpy(a) for a in (
        imgs.astype(np.float32), labels == 7, labels == 13, disp_norm * np.float32(W * 4.0))]


def _cam(cfg, focal):
    return pipeline._scaled_camera(cfg, pipeline._scalar(focal))[0]


def _counts():
    return dict(pipeline.SemanticDepthPipeline.tail_graphs)


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


def _equal(a: pipeline.FrameOutputs, b: pipeline.FrameOutputs) -> bool:
    return all(torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
               for x, y in zip(a.leaves(), b.leaves()))


class _EagerCapture:
    """``graphs.Captured`` on the CPU: the capture keeps the call, a replay
    makes it."""

    def __init__(self, fn, inputs, *args):
        self.fn, self.args = fn, args

    def __call__(self, inputs):
        return self.fn(*inputs, *self.args)


@pytest.fixture
def served(monkeypatch):
    """The dispatch as on the card: every input graphable, the capture
    eager."""
    monkeypatch.setattr(graphs, "graphable", lambda tensors: True)
    monkeypatch.setattr(graphs, "Captured", _EagerCapture)


def test_tail_key_separates_batch_config_and_focal(pipe, scenes):
    cfg = pipe.config
    key = pipeline._tail_key(cfg, scenes, _cam(cfg, 380.0))
    assert key == pipeline._tail_key(cfg, [t.clone() for t in scenes], _cam(cfg, 380.0))
    one = [t[:1] for t in scenes]
    assert pipeline._tail_key(cfg, one, _cam(cfg, 380.0)) != key
    deeper = dataclasses.replace(cfg, depth=cfg.depth + 1.0)
    assert pipeline._tail_key(deeper, scenes, _cam(deeper, 380.0)) != key
    assert pipeline._tail_key(cfg, scenes, _cam(cfg, 380.25)) != key
    # a float focal and a 0-d CPU tensor of the same value give one key
    assert pipeline._tail_key(cfg, scenes, pipeline._scaled_camera(cfg, 380.0)[0]) == key
    doubles = [scenes[0].double()] + scenes[1:]
    assert pipeline._tail_key(cfg, doubles, _cam(cfg, 380.0)) != key


def test_tail_key_is_none_for_a_camera_field_off_the_cpu(pipe, scenes):
    cam = dataclasses.replace(_cam(pipe.config, 380.0), focal=torch.tensor(380.0, device="meta"))
    assert pipeline._tail_key(pipe.config, scenes, cam) is None


def test_cache_evicts_its_oldest_graph_past_four():
    cache = graphs.Cache()
    for k in range(4):
        cache.put(k, f"g{k}")
    assert cache.get(0) == "g0"  # now the most recently used
    cache.put(4, "g4")
    assert list(cache.graphs) == [2, 3, 0, 4]
    assert cache.get(1) is None
    assert graphs.SIZE == cache.size == 4


def test_cache_forgets_keys_seen_once_past_four():
    cache = graphs.Cache()
    assert [cache.seen_before(k) for k in range(5)] == [False] * 5
    assert not cache.seen_before(0)  # pushed out by key 4, so seen afresh
    assert cache.seen_before(4) and cache.seen_before(0)
    assert not cache.seen_before(4)  # a second sight takes the key off the list


def test_the_cpu_runs_the_tail_eagerly(pipe, scenes):
    cam = _cam(pipe.config, 380.0)
    before = _counts()
    outs = [pipe._batch_geometry(*scenes, cam) for _ in range(3)]
    assert _delta(before) == dict(eager=3, captures=0, replays=0)
    assert not pipe._tail_graphs.graphs and not pipe._tail_graphs.seen
    assert _equal(outs[0], outs[2])


@pytest.mark.parametrize("n", [3, 5])
def test_a_key_runs_eager_then_captures_then_replays(pipe, scenes, served, n):
    cam = _cam(pipe.config, 381.0 + n)
    want = pipe._tail_body(*scenes, cam)
    before = _counts()
    outs = [pipe._batch_geometry(*scenes, cam) for _ in range(n)]
    assert _delta(before) == dict(eager=1, captures=1, replays=n - 2)
    assert all(_equal(o, want) for o in outs)


def test_distinct_focals_capture_nothing(pipe, scenes, served):
    before = _counts()
    for i in range(6):
        pipe._batch_geometry(*scenes, _cam(pipe.config, 390.0 + i))
    assert _delta(before) == dict(eager=6, captures=0, replays=0)


def test_a_replaced_config_captures_anew(scenes, served):
    torch.manual_seed(0)
    p = pipeline.SemanticDepthPipeline(
        config.munich_pipeline_config(input_height=H, input_width=W),
        FCN8s(width_mult=0.0625, fc_channels=32), Monodepth(width_mult=0.0625), device="cpu")
    cam = _cam(p.config, 380.0)
    before = _counts()
    for _ in range(3):
        p._batch_geometry(*scenes, cam)
    p.config = dataclasses.replace(p.config, depth=p.config.depth + 0.5)
    for _ in range(3):
        p._batch_geometry(*scenes, cam)
    assert _delta(before) == dict(eager=2, captures=2, replays=2)
    assert len(p._tail_graphs.graphs) == 2


def test_the_launch_counters_move_together():
    """A replay adds what its capture counted, through each wrapper's
    module-level name, and the capture takes its counts back."""
    counters = graphs._counters()
    assert {(m.__name__.rsplit(".", 1)[-1], c) for m, _, c in counters} == {
        ("knn_grid", "launches"), ("knn_grid", "general_launches"), ("mad", "launches"),
        ("radius", "launches"), ("exact_knn", "launches"), ("exact_knn", "large_k_launches")}
    before = graphs._read(counters)
    deltas = list(range(1, len(counters) + 1))
    graphs._add(counters, deltas)
    assert [a - b for a, b in zip(graphs._read(counters), before)] == deltas
    graphs._add(counters, [-d for d in deltas])
    assert graphs._read(counters) == before
    assert knn_grid.knn_mean_distances_grid.launches == before[0]
    assert (mad.mad_keep_mask.launches, radius.radius_counts.launches,
            exact_knn.knn_mean_distances_exact.launches) == (before[2], before[3], before[4])


@pytest.mark.parametrize("value", [1.0, 0.6, 0.25, 2.25, (255.0, 0.0, 255.0),
                                   float(np.float32(128) / np.float32(255.0))])
def test_device_constant_is_made_once_and_keeps_the_float32_bits(value):
    got = runtime.device_constant(value, "cpu")
    assert runtime.device_constant(value, torch.device("cpu")) is got
    want = torch.tensor(value, dtype=torch.float32)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert not got.is_inference()


def test_device_constant_while_export_traces_is_fresh():
    class M(torch.nn.Module):
        def forward(self, x):
            return x / runtime.device_constant(3.5, x.device)

    n = len(runtime._CONSTANTS)
    prog = torch.export.export(M(), (torch.ones(3),), strict=False)
    assert len(runtime._CONSTANTS) == n
    assert all(type(t) is torch.Tensor for t in runtime._CONSTANTS.values())
    assert torch.equal(prog.module()(torch.full((3,), 7.0)), torch.full((3,), 2.0))


def test_nothing_is_graphable_on_the_cpu_or_while_export_traces():
    seen = []

    class M(torch.nn.Module):
        def forward(self, x):
            seen.append(graphs.graphable([]))
            return x + 1

    assert graphs.graphable([])
    torch.export.export(M(), (torch.ones(3),), strict=False)
    assert seen and not any(seen)
    assert not graphs.graphable([torch.ones(3)])
    assert not graphs.graphable([torch.ones(3, device="meta")])
