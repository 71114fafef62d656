"""The CUDA graphs of the geometry tail and of monodepth (``graphs``,
``pipeline._batch_geometry``, ``pipeline._batch_disparity``) and the frame
program's device constants (``runtime.device_constant``) on the CPU: the
graph keys, the cache's order, how the dispatch serves a key (with the
capture stood in for by an eager call, since the CPU captures nothing), and
that the CPU, torch.export and the row-sharded path take the eager body.
The card's half, the replays against the eager body, is in
``test_torch_cuda.py``."""

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

    def __call__(self, inputs, clone=True):
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


# --- monodepth's graph (``_batch_disparity``) ---------------------------------

def _mono_counts():
    return dict(pipeline.SemanticDepthPipeline.mono_graphs)


def _mono_delta(before):
    return {k: v - before[k] for k, v in _mono_counts().items()}


def _small(b=2, h=H, w=W, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((b, h, w, 3), generator=g) * 255.0


def _mono_pipe(encoder="vgg", input_s2d=False, flip=True, h=H, w=W):
    cfg = config.munich_pipeline_config(input_height=h, input_width=w)
    cfg = dataclasses.replace(cfg, monodepth=dataclasses.replace(
        cfg.monodepth, encoder=encoder, flip_average=flip))
    torch.manual_seed(0)
    return pipeline.SemanticDepthPipeline(
        cfg, FCN8s(width_mult=0.0625, fc_channels=32),
        Monodepth(encoder=encoder, width_mult=0.0625, input_s2d=input_s2d), device="cpu")


def _bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _key_change(pipe, small, change):
    """(config, mono, small) after ``change``."""
    cfg, mono = pipe.config, pipe.mono
    if change == "batch":
        small = small[:1]
    elif change == "shape":
        small = small[:, :, : W // 2]
    elif change == "dtype":
        small = small.double()
    elif change == "flip":
        cfg = dataclasses.replace(cfg, monodepth=dataclasses.replace(
            cfg.monodepth, flip_average=not cfg.monodepth.flip_average))
    elif change == "module":
        torch.manual_seed(0)
        mono = Monodepth(width_mult=0.0625)
    elif change == "weights_moved":
        mono = mono.to(torch.float64)
    return cfg, mono, small


@pytest.mark.parametrize("change, same", [
    ("nothing", True), ("batch", False), ("shape", False), ("dtype", False), ("flip", False),
    ("module", False), ("weights_moved", False),
])
def test_mono_key_separates_batch_shape_dtype_flip_and_weights(change, same):
    """A new batch, frame shape, dtype or flip setting takes a new key, as
    does a module put in ``mono``'s place (same weights, another object) or
    the weights moved by ``.to()``; the same call on a copy of ``small``
    keeps it."""
    pipe = _mono_pipe()
    small = _small()
    key = pipeline._mono_key(pipe.config, pipe.mono, small)
    got = pipeline._mono_key(*_key_change(pipe, small.clone(), change))
    assert (got == key) is same


def test_mono_key_keeps_weights_loaded_in_place():
    pipe = _mono_pipe()
    small = _small()
    key = pipeline._mono_key(pipe.config, pipe.mono, small)
    torch.manual_seed(1)
    pipe.mono.load_state_dict(Monodepth(width_mult=0.0625).state_dict())
    assert pipeline._mono_key(pipe.config, pipe.mono, small) == key


@pytest.mark.parametrize("n", [3, 5])
def test_monodepth_runs_eager_then_captures_then_replays(served, n):
    """Each call a new ``disparity_mult`` (not in the key): one eager call,
    one capture, then replays, each the body times its multiplier, bit for
    bit; ``mono_graphs`` counts each."""
    pipe = _mono_pipe()
    small = _small(seed=n)
    mults = [pipeline._scalar(250.0 + 0.5 * i) for i in range(n)]
    want = [pipe._mono_body(small) * m for m in mults]
    before = _mono_counts()
    outs = [pipe._batch_disparity(small, m) for m in mults]
    assert _mono_delta(before) == dict(eager=1, captures=1, replays=n - 2)
    assert all(_bits(o, w_) for o, w_ in zip(outs, want))
    assert len(pipe._mono_graphs.graphs) == 1


def test_weights_loaded_in_place_are_read_by_the_next_replay(served):
    pipe = _mono_pipe()
    small, mult = _small(seed=7), pipeline._scalar(250.0)
    for _ in range(3):
        pipe._batch_disparity(small, mult)
    torch.manual_seed(2)
    pipe.mono.load_state_dict(Monodepth(width_mult=0.0625).state_dict())
    before = _mono_counts()
    got = pipe._batch_disparity(small, mult)
    assert _mono_delta(before) == dict(eager=0, captures=0, replays=1)
    assert _bits(got, pipe._mono_body(small) * mult)


class _RowsMono(torch.nn.Module):
    """A stand-in monodepth that takes ``rows`` (the sp path without a
    process group): the images' first channel."""

    def disp_left(self, images, rows=None):
        self.rows = rows
        return images[..., 0]


def test_the_row_sharded_path_runs_monodepth_eagerly(served):
    pipe = _mono_pipe()
    pipe.mono = _RowsMono()
    small, mult, rows = _small(), pipeline._scalar(250.0), object()
    before = _mono_counts()
    outs = [pipe._batch_disparity(small, mult, rows) for _ in range(3)]
    assert _mono_delta(before) == dict(eager=3, captures=0, replays=0)
    assert pipe.mono.rows is rows and not pipe._mono_graphs.seen
    assert all(_bits(o, outs[0]) for o in outs)


def test_torch_export_traces_monodepth_eagerly(monkeypatch):
    """Every input graphable but for the trace itself: torch.export traces
    the eager body, and the program equals the live call."""
    monkeypatch.setattr(graphs, "graphable", lambda tensors: not torch.compiler.is_compiling())
    monkeypatch.setattr(graphs, "Captured", _EagerCapture)
    pipe = _mono_pipe()

    class M(torch.nn.Module):
        def forward(self, small, mult):
            return pipe._batch_disparity(small, mult)

    small, mult = _small(), torch.tensor(250.0)
    before = _mono_counts()
    prog = torch.export.export(M(), (small, mult), strict=False)
    assert _mono_delta(before)["eager"] >= 1
    assert _mono_delta(before)["captures"] == 0 and not pipe._mono_graphs.seen
    with torch.inference_mode():
        assert _bits(prog.module()(small, mult), pipe._mono_body(small) * mult)


def _postprocess_with_host_divisor(disp):
    """``flip_average_postprocess`` with its divisor made from the input
    (``new_tensor``), as the port computed it before the divisors became
    device constants."""
    h, w = disp.shape[-2:]
    l_disp = disp[..., 0, :, :]
    r_disp = disp[..., 1, :, :].flip(-1)
    m_disp = 0.5 * (l_disp + r_disp)
    ramp = torch.arange(w, dtype=torch.float32, device=disp.device)
    ramp = ramp / ramp.new_tensor(float(w - 1))
    l_mask = (1.0 - torch.clamp(20.0 * (ramp - 0.05), 0.0, 1.0)).expand(h, w)
    r_mask = l_mask.flip(-1)
    return r_mask * l_disp + l_mask * r_disp + (1.0 - l_mask - r_mask) * m_disp


def _disparity_with_host_divisors(pipe, small, mult):
    b = small.shape[0]
    norm = small.float() / small.new_tensor(255.0)
    if pipe.config.monodepth.flip_average:
        disp_all = pipe.mono.disp_left(torch.cat([norm, norm.flip(2)], dim=0))
        pairs = torch.stack([disp_all[:b], disp_all[b:]], dim=1)
        return _postprocess_with_host_divisor(pairs) * mult
    return pipe.mono.disp_left(norm) * mult


@pytest.mark.parametrize("encoder, input_s2d, flip, hw", [
    ("vgg", False, True, (H, W)),
    ("resnet50", False, True, (H, W)),
    ("vgg", True, False, (2 * H, 2 * W)),
    ("vgg", False, False, (H, W)),
], ids=["vgg", "resnet50", "native_s2d", "no_flip"])
def test_batch_disparity_keeps_the_bits_of_host_divisors(encoder, input_s2d, flip, hw):
    """The divisions by ``device_constant`` (255 and w - 1) give the bits
    the divisions by a tensor made from the input gave, for each encoder,
    the native s2d path and the flip off."""
    pipe = _mono_pipe(encoder, input_s2d, flip, *hw)
    small, mult = _small(2, *hw, seed=3), pipeline._scalar(250.0 * hw[1] / 512.0)
    with torch.inference_mode():
        got = pipe._batch_disparity(small, mult)
        want = _disparity_with_host_divisors(pipe, small, mult)
    assert got.shape == (2,) + hw and _bits(got, want)
