"""Frozen serving in the port against the live port pipeline and against the
JAX package's exported program, on the CPU: the four kernels as dispatcher
ops (``torch.library.opcheck``), the tensor-focal route of
``process_batch``, ``export.export_pipeline`` / ``load_pipeline`` bit for
bit against the live pipeline, the JAX program within rtol 1e-3, the meta
sidecar and the program's fixed batch."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_depth_tpu import config as jconfig
from semantic_depth_tpu import export as jexport
from semantic_depth_tpu import pipeline as jpipeline
from semantic_depth_tpu.models import FCN8s as JaxFCN8s
from semantic_depth_tpu.models import Monodepth as JaxMonodepth
from semantic_depth_tpu_torch import config as tconfig
from semantic_depth_tpu_torch import export as texport
from semantic_depth_tpu_torch import pipeline as tpipeline
from semantic_depth_tpu_torch import runtime
from semantic_depth_tpu_torch.models import FCN8s, Monodepth
from semantic_depth_tpu_torch.models.from_flax import load_flax
from semantic_depth_tpu_torch.ops import exact_knn, knn_grid, mad, pcl, radius

from torch_helpers import numpy_params

torch.set_num_threads(2)  # six xdist workers share the machine

# the tiny networks put these noise frames' road cloud near z = -13.4 m
# (tests/test_torch_cli.py), so the programs measure a road width there
_DEPTH = 13.4
_FOCALS = (380.0, 386.7)


def _cfg(config_mod, **kw):
    return config_mod.munich_pipeline_config(input_height=128, input_width=256, depth=_DEPTH,
                                             **kw)


@pytest.fixture(scope="module")
def tiny():
    """The JAX and the port pipeline on the same numpy-seeded parameters,
    and two 96x192 noise frames."""
    jfcn = JaxFCN8s(num_classes=3, width_mult=0.0625, fc_channels=32)
    jmono = JaxMonodepth(encoder="vgg", width_mult=0.0625)
    x = np.zeros((1, 128, 256, 3), np.float32)
    fcn_params, mono_params = numpy_params(jfcn, x, seed=0), numpy_params(jmono, x, seed=1)
    jpipe = jpipeline.SemanticDepthPipeline(_cfg(jconfig), fcn_params, mono_params,
                                            fcn=jfcn, mono=jmono)
    fcn = load_flax(FCN8s(num_classes=3, width_mult=0.0625, fc_channels=32), fcn_params)
    mono = load_flax(Monodepth("vgg", width_mult=0.0625), mono_params)
    tpipe = tpipeline.SemanticDepthPipeline(_cfg(tconfig), fcn, mono, device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (2, 96, 192, 3)).astype(np.uint8)
    return jpipe, tpipe, frames


@pytest.fixture(scope="module")
def programs(tiny, tmp_path_factory):
    """Port programs: single-frame scalars-only and batched-2 full outputs,
    exported with program tracing on; ``spans``, what tracing recorded."""
    _, tpipe, _ = tiny
    root = tmp_path_factory.mktemp("programs")
    with runtime.tracing():
        single = texport.export_pipeline(tpipe, str(root / "single.pt2"), (96, 192, 3))
        batched = texport.export_pipeline(tpipe, str(root / "b2.pt2"), (2, 96, 192, 3),
                                          batched=True, scalars_only=False)
    return dict(single=single, batched=batched, spans=runtime.stats())


def _assert_same(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    np.testing.assert_array_equal(got, want, err_msg=name)  # nan equal to nan


def _assert_outputs_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, pcl.MaskedCloud):
            for n in ("xyz", "rgb", "valid"):
                _assert_same(getattr(a, n), getattr(b, n), f"{f.name}.{n}")
        else:
            _assert_same(a, b, f.name)


# --- the ops ------------------------------------------------------------------


def _op_cases():
    g = torch.Generator().manual_seed(0)
    pts, grid_ok = torch.randn(2, 8, 24, 3, generator=g), torch.rand(2, 8, 24, generator=g) < 0.7
    vals, rows_ok = torch.randn(4, 64, generator=g), torch.rand(4, 64, generator=g) < 0.8
    xyz, ok = torch.randn(2, 256, 3, generator=g), torch.rand(2, 256, generator=g) < 0.6
    return {
        "knn_grid": (knn_grid._knn_grid_op, (pts, grid_ok, 10, [5, 21])),
        "mad_keep_pair": (mad._mad_op, (vals, rows_ok, None, 2.0, 3.0, 2)),
        "mad_keep_rows": (mad._mad_op, (vals, rows_ok, torch.tensor([1.0, 2, 3, 4]), 0.0, 0.0,
                                        4)),
        "radius_counts": (radius._radius_op, (xyz, ok, ok.float() * 0.5, 0.5, True)),
        "exact_knn": (exact_knn._exact_knn_op, (xyz, ok, 10, True)),
    }


@pytest.mark.parametrize("name", ["knn_grid", "mad_keep_pair", "mad_keep_rows", "radius_counts",
                                  "exact_knn"])
def test_ops_pass_opcheck(name):
    op, args = _op_cases()[name]
    assert str(op._qualname).startswith("sd_torch::")
    torch.library.opcheck(op, args)


def test_wrappers_go_through_the_ops():
    """Each public wrapper's CPU result is its op's, which is the plain
    version's."""
    cases = _op_cases()
    g = torch.Generator().manual_seed(1)
    pts, grid_ok = cases["knn_grid"][1][:2]
    _assert_same(knn_grid.knn_mean_distances_grid(pts, grid_ok, 10),
                 torch.ops.sd_torch.knn_grid(pts, grid_ok, 10, [5, 21]))
    vals, rows_ok = cases["mad_keep_pair"][1][:2]
    _assert_same(mad.mad_keep_mask(vals, rows_ok, (2.0, 3.0)),
                 mad.mad_keep_mask_plain(vals, rows_ok, torch.tensor([2.0, 2.0, 3.0, 3.0])))
    xyz, ok = cases["exact_knn"][1][:2]
    w = torch.rand(ok.shape, generator=g)
    _assert_same(radius.radius_counts(xyz, ok, w, 0.5),
                 torch.ops.sd_torch.radius_counts(xyz, ok, w, 0.5, True))
    _assert_same(exact_knn.knn_mean_distances_exact(xyz, ok, 10),
                 exact_knn.knn_mean_distances_exact_plain(xyz, ok, 10))


# --- the tensor-focal route ------------------------------------------------------


def _float_route(pipe, frames, focal, mult):
    """The live route before the tensor route: focal and multiplier rounded
    to float32 Python floats."""
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    cam, s_w = tpipeline._scaled_camera(pipe.config, f32(focal))
    with torch.inference_mode():
        small, road, fence = pipe._batch_segment(torch.from_numpy(frames))
        disps = pipe._batch_disparity(small, f32(f32(mult) * s_w))
        return pipe._batch_geometry(small, road, fence, disps, cam)


@pytest.mark.parametrize("estimator", ["slab_minmax", "plane_edge"])
def test_tensor_focal_route_bit_equal_to_the_float_route(tiny, estimator):
    _, tpipe, frames = tiny
    pipe = tpipeline.SemanticDepthPipeline(_cfg(tconfig, rw_estimator=estimator), tpipe.fcn,
                                           tpipe.mono, device="cpu")
    for focal in _FOCALS:
        got = pipe.process_batch(frames, focal=focal)
        assert bool(got.rw_found.any())
        _assert_outputs_equal(got, _float_route(pipe, frames, focal, 192.0))


def test_public_segment_and_disparity_equal_the_batch_stages(tiny):
    _, tpipe, frames = tiny
    out = tpipe.process_batch(frames[:1])
    road, fence, probs = tpipe.segment(out.frame_small[0])
    assert probs.shape == (128, 256, 3)
    _assert_same(road, out.road_mask[0])
    _assert_same(fence, out.fence_mask[0])
    # the width factor of 128x256 is 0.5: the batch route's multiplier is 96
    _assert_same(tpipe.disparity(out.frame_small[0], 96.0), out.disparity[0])


# --- programs against the live pipeline --------------------------------------------


def test_single_frame_scalars_program_bit_equal_to_live(tiny, programs):
    _, tpipe, frames = tiny
    call = texport.load_pipeline(programs["single"])
    assert call.frame_shape == (96, 192, 3)
    for focal in _FOCALS:
        dist_rw, dist_f2f, found = call(frames[0], focal, 192.0)
        want = tpipe.process_frame(frames[0], focal=focal)
        _assert_same(dist_rw, want.dist_rw)
        _assert_same(dist_f2f, want.dist_f2f)
        _assert_same(found, want.rw_found)
    assert bool(found) and np.isfinite(float(dist_rw))
    # float frames are cast to the program's uint8
    _assert_same(call(frames[0].astype(np.float32), _FOCALS[1], 192.0)[0], want.dist_rw)


def test_batched_full_program_bit_equal_to_live(tiny, programs):
    _, tpipe, frames = tiny
    call = texport.load_pipeline(programs["batched"])
    for focal in _FOCALS:
        got = call(frames, focal, 150.0)
        assert isinstance(got, tpipeline.FrameOutputs)
        _assert_outputs_equal(got, tpipe.process_batch(frames, focal=focal, disparity_mult=150.0))


def test_wrong_batch_raises(tiny, programs):
    _, _, frames = tiny
    call = texport.load_pipeline(programs["batched"])
    with pytest.raises(ValueError, match=r"shape \(2, 96, 192, 3\)"):
        call(frames[:1], 380.0, 192.0)
    with pytest.raises(ValueError, match="rank-4"):
        texport.export_pipeline(tiny[1], "unused.pt2", (96, 192, 3), batched=True)


def _op_calls(path):
    """{op name: calls} of the sd_torch ops in a saved program, and its
    count of round ops."""
    targets = [str(n.target) for n in torch.export.load(path).graph.nodes
               if n.op == "call_function"]
    ops = {}
    for t in targets:
        if t.startswith("sd_torch."):
            ops[t.split(".")[1]] = ops.get(t.split(".")[1], 0) + 1
    return ops, sum("round" in t for t in targets)


def test_export_turns_program_tracing_off(programs):
    """Exported inside ``runtime.tracing()``, the trace opened no span, and
    no profiler op is in either program."""
    assert programs["spans"] == {}
    for key in ("single", "batched"):
        targets = [str(n.target) for n in torch.export.load(programs[key]).graph.nodes
                   if n.op == "call_function"]
        assert targets and not any("profiler" in t for t in targets)


def test_program_calls_the_kernel_ops(tiny, programs, tmp_path):
    """A program holds the kernels as op calls, as many as the live batch
    launches (grid and exact mode); a scalars-only program drops the
    overlay (its round and clamp)."""
    single, rounds_single = _op_calls(programs["single"])
    batched, rounds_full = _op_calls(programs["batched"])
    assert single == batched == {"knn_grid": 1, "mad_keep": 4, "radius_counts": 1}
    assert rounds_single < rounds_full
    _, tpipe, _ = tiny
    cfg = _cfg(tconfig)
    cfg = dataclasses.replace(cfg, road=dataclasses.replace(cfg.road, stat_mode="exact"))
    pipe = tpipeline.SemanticDepthPipeline(cfg, tpipe.fcn, tpipe.mono, device="cpu")
    exact, _ = _op_calls(texport.export_pipeline(pipe, str(tmp_path / "exact.pt2"), (96, 192, 3)))
    assert exact == {"mad_keep": 4, "radius_counts": 1, "exact_knn": 1}


# --- against the JAX program ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_program(tiny, tmp_path_factory):
    jpipe, _, _ = tiny
    path = str(tmp_path_factory.mktemp("jax") / "single.shlo")
    jexport.export_pipeline(jpipe, path, frame_shape=(96, 192, 3))
    return path


def test_program_matches_the_jax_program(tiny, programs, jax_program):
    _, _, frames = tiny
    want_call = jexport.load_pipeline(jax_program)
    got_call = texport.load_pipeline(programs["single"])
    found = 0
    for focal in _FOCALS:
        for frame in frames:
            want = [np.asarray(x) for x in want_call(jnp.asarray(frame), focal, 192.0)]
            got = [x.numpy() for x in got_call(frame, focal, 192.0)]
            for g, w in zip(got[:2], want[:2]):
                np.testing.assert_allclose(g, w, rtol=1e-3, equal_nan=True)
            found += int(want[2])
    assert found > 0


def test_meta_sidecar_equals_jax(programs, jax_program):
    with open(jax_program + ".meta.json") as f:
        want = json.load(f)
    got = texport.load_pipeline_meta(programs["single"])
    assert got == want
    assert texport.load_pipeline_meta(programs["single"] + ".missing") is None
