"""Multi-device serving of the port (``semantic_depth_tpu_torch.parallel``)
on the CPU: groups of 2 to 4 gloo ranks started by ``launch.run_ranks``, at
the JAX sharded tests' small shapes (tests/test_parallel.py). Each sharded
run is held against the JAX single-device ``process_batch`` (at the
tolerances of tests/test_torch_pipeline.py) and against the port's own
single-process ``process_batch`` (at the JAX sharded tests' tolerances),
and every rank must hold the same outputs. The JAX sharded programs do
not run here: the JAX tests hold them against JAX single."""

import dataclasses

import numpy as np
import pytest
import torch

from semantic_depth_tpu import config as jconfig
from semantic_depth_tpu import pipeline as jpipeline
from semantic_depth_tpu.models import FCN8s as JaxFCN8s
from semantic_depth_tpu.models import Monodepth as JaxMonodepth
from semantic_depth_tpu_torch import config as tconfig
from semantic_depth_tpu_torch import pipeline as tpipeline
from semantic_depth_tpu_torch.models import FCN8s, Monodepth
from semantic_depth_tpu_torch.models.from_flax import load_flax
from semantic_depth_tpu_torch.parallel import make_mesh, make_pp_mesh, make_spatial_mesh
from semantic_depth_tpu_torch.parallel.launch import run_ranks

import test_torch_parallel_ranks as cases
from torch_helpers import numpy_params

torch.set_num_threads(2)  # six xdist workers share the machine

_TIMEOUT = 240  # seconds for one group of ranks, its collectives included


def _setup(encoder, s2d, h):
    """The JAX pipeline, the port's and the ranks' spec on the same
    numpy-seeded parameters. Seeded networks put few pixels on the road
    and their noisy disparity leaves no road point after the denoise
    chain, so, as chip_smoke.py's ``measurable`` does, the road logit gets
    +2 (nearly every pixel road), the multiplier is ``_MULT`` and the
    measuring depth is the denoised road cloud's median: the road widths
    are then measured."""
    w = 2 * h
    fcn_kw = dict(num_classes=3, width_mult=0.0625, fc_channels=32, input_s2d=s2d)
    mono_kw = dict(encoder=encoder, width_mult=0.0625, input_s2d=s2d)
    fp = numpy_params(JaxFCN8s(**fcn_kw), np.zeros((1, h, w, 3), np.float32), seed=0)
    fp["params"]["upscore8"]["bias"][0::3] += 2.0  # the road class of every pixel phase
    mp = numpy_params(JaxMonodepth(**mono_kw), np.zeros((2, h, w, 3), np.float32), seed=1)
    fcn, mono = load_flax(FCN8s(**fcn_kw), fp), load_flax(Monodepth(**mono_kw), mp)

    def cfg_of(config_mod, depth=None):
        base = config_mod.munich_pipeline_config()
        cfg = config_mod.munich_pipeline_config(
            input_height=h, input_width=w, approach="rw",
            road=dataclasses.replace(base.road, neighbor_capacity=2048))
        cfg = dataclasses.replace(cfg, monodepth=dataclasses.replace(
            cfg.monodepth, encoder=encoder, flip_average=not s2d))
        return cfg if depth is None else dataclasses.replace(cfg, depth=depth)

    tpipe = tpipeline.SemanticDepthPipeline(cfg_of(tconfig), fcn, mono, device="cpu")
    out = tpipe.process_batch(_FRAMES[:4], disparity_mult=_MULT)
    z = out.road_cloud.xyz[..., 2][out.road_cloud.valid]
    depth = -float(z.median()) + tpipe.config.rw_depth_offset
    tpipe.config = cfg_of(tconfig, depth)
    jpipe = jpipeline.SemanticDepthPipeline(cfg_of(jconfig, depth), fp, mp,
                                            fcn=JaxFCN8s(**fcn_kw), mono=JaxMonodepth(**mono_kw))
    spec = dict(config=tpipe.config, fcn_kw=fcn_kw, mono_kw=mono_kw,
                fcn_state=fcn.state_dict(), mono_state=mono.state_dict())
    return jpipe, tpipe, spec


_MULT = 250.0
_FRAMES = np.random.default_rng(0).integers(0, 256, size=(8, 256, 512, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def setups():
    return dict(vgg=_setup("vgg", False, 128), resnet50=_setup("resnet50", False, 128),
                s2d=_setup("vgg", True, 256))


# (name, world, kind, pipe, batch, extra): the cases, grouped by world size
_CASES = (
    ("dp2", 2, "dp", "vgg", 4, {}),
    ("sp2_resnet50", 2, "sp", "resnet50", 2, {}),
    ("pp3", 3, "pp", "vgg", 8, dict(microbatch=2)),
    ("dp4", 4, "dp", "vgg", 4, {}),
    ("dp2_sp2", 4, "sp", "vgg", 2, dict(dp=2)),
    ("sp4_s2d", 4, "sp", "s2d", 1, {}),
    ("pp2_dp2", 4, "pp", "vgg", 8, dict(dp=2, microbatch=4)),
)


def _bf16(spec):
    """``spec`` with both networks computing in bfloat16."""
    kw = dict(compute_dtype=torch.bfloat16)
    return dict(spec, fcn_kw=dict(spec["fcn_kw"], **kw), mono_kw=dict(spec["mono_kw"], **kw),
                config=dataclasses.replace(spec["config"], compute_dtype="bfloat16"))


@pytest.fixture(scope="module")
def groups(setups):
    """One group of ranks per world size, each running all its cases; the
    world of 2 also runs sp on bfloat16 networks, the world of 3 the halo
    unit case, and the world of 4 the error cases."""
    specs = {k: v[2] for k, v in setups.items()}
    specs["vgg_bf16"] = _bf16(specs["vgg"])
    out = {}
    for world in (2, 3, 4):
        todo = [dict(name=name, kind=kind, pipe=pipe, frames=_FRAMES[:batch],
                     disparity_mult=_MULT, **extra)
                for name, w, kind, pipe, batch, extra in _CASES if w == world]
        if world == 2:
            todo.append(dict(name="sp2_bf16", kind="sp", pipe="vgg_bf16", frames=_FRAMES[:2],
                             disparity_mult=_MULT))
        if world == 3:
            todo.append(dict(name="halo", kind="halo", args=(5, 2, 1)))
        if world == 4:
            todo.append(dict(name="errors", kind="errors", pipe="vgg", frames=_FRAMES))
        out[world] = run_ranks(cases.run_cases, world, todo, specs, timeout_s=_TIMEOUT,
                               device="cpu")
    return out


@pytest.fixture(scope="module")
def references(setups):
    """JAX single-device outputs (one batch per network) and the port's
    single-process outputs of each case's frames."""
    jax_out = {}
    for key, batch in (("vgg", 8), ("resnet50", 2), ("s2d", 1)):
        jout = setups[key][0].process_batch(_FRAMES[:batch], disparity_mult=_MULT)
        jax_out[key] = {f: np.asarray(getattr(jout, f)) for f in cases.FIELDS}
    port = {}
    for name, _, _, pipe, batch, _ in _CASES:
        pout = setups[pipe][1].process_batch(_FRAMES[:batch], disparity_mult=_MULT)
        port[name] = {f: getattr(pout, f).numpy() for f in cases.FIELDS}
    return jax_out, port


def _against_jax(got, want):
    """tests/test_torch_pipeline.py's tolerances (the two frameworks' conv
    orders and resize rounding)."""
    small_diff = np.abs(got["frame_small"] - want["frame_small"])
    assert small_diff.max() <= 1.0 and (small_diff > 0).mean() < 1e-3
    for name in ("road_mask", "fence_mask"):
        assert (got[name] != want[name]).mean() < 1e-3
    np.testing.assert_allclose(got["disparity"], want["disparity"], rtol=0, atol=1e-3,
                               equal_nan=True)
    np.testing.assert_allclose(got["dist_rw"], want["dist_rw"], rtol=1e-3, equal_nan=True)


def _against_port(got, want, masks_equal):
    """The JAX sharded tests' tolerances (tests/test_parallel.py)."""
    np.testing.assert_allclose(got["disparity"], want["disparity"], rtol=1e-5, atol=1e-5)
    a, b = got["dist_rw"], want["dist_rw"]
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(b)
    np.testing.assert_allclose(a[ok], b[ok], rtol=1e-4)
    if masks_equal:
        np.testing.assert_array_equal(got["road_mask"], want["road_mask"])


@pytest.mark.parametrize("name,world,kind,pipe,batch,extra", _CASES,
                         ids=[c[0] for c in _CASES])
def test_sharded_serving_matches_jax_and_the_single_process_port(
        groups, references, name, world, kind, pipe, batch, extra):
    ranks = groups[world]
    res = [r[name] for r in ranks]
    assert len({r["digest"] for r in res}) == 1  # every rank holds the same outputs
    got = res[0]["out"]
    jax_out, port = references
    assert got["disparity"].shape[0] == batch
    want = {f: v[:batch] for f, v in jax_out[pipe].items()}
    _against_jax(got, want)
    _against_port(got, port[name], masks_equal=kind == "pp")
    assert np.isfinite(port[name]["disparity"]).all()
    traffic = res[0]["traffic"]
    if kind == "sp":
        # the networks ran row-sharded: halos moved, not whole frames
        assert traffic["halo"]["calls"] > 10 and traffic["gather"]["calls"] >= 1
    elif kind == "pp":
        assert traffic["handoff"]["calls"] >= 1 and traffic["broadcast"]["calls"] == 1
        assert traffic["halo"]["calls"] == 0
    else:
        assert traffic["gather"]["calls"] == 1 and traffic["halo"]["calls"] == 0


def test_sp_bfloat16_is_bit_equal_to_the_single_process_port(groups, setups):
    """sp=2 on bfloat16 networks gives the single-process bfloat16 port's
    bits on the CPU, halo rows included. On the card cuDNN picks its
    bfloat16 algorithms by shape, so a row block rounds apart from the
    whole map now and then: chip_smoke.py phase 11 (c) bounds that."""
    want = cases.build_pipeline(_bf16(setups["vgg"][2])).process_batch(
        _FRAMES[:2], disparity_mult=_MULT)
    res = [r["sp2_bf16"] for r in groups[2]]
    assert len({r["digest"] for r in res}) == 1
    assert res[0]["traffic"]["halo"]["calls"] > 10
    for f in cases.FIELDS:
        np.testing.assert_array_equal(res[0]["out"][f], getattr(want, f).numpy(), err_msg=f)
    assert np.isfinite(res[0]["out"]["disparity"]).all()


def test_some_road_widths_are_measured(references):
    """The cases above compare finite widths, not only nan patterns."""
    _, port = references
    for name, p in port.items():
        assert np.isfinite(p["dist_rw"]).any(), name


def test_halo_rows_and_all_gather_dim_are_bit_exact(groups):
    """Three ranks of 5-row blocks, 2 rows above and 1 below: each rank gets
    its neighbours' edge rows (-0.0 and nan bits kept), zeros beyond the
    frame, and the gathers give the whole frame back in rank order."""
    frame = cases.halo_frame(15)
    padded = torch.nn.functional.pad(frame, (0, 0, 2, 1))  # zero rows beyond the edges
    for rank, res in enumerate(r["halo"] for r in groups[3]):
        want = padded[:, :, 5 * rank:5 * rank + 8]
        np.testing.assert_array_equal(res["ext"], want.view(torch.int32).numpy())
        np.testing.assert_array_equal(res["whole"], frame.view(torch.int32).numpy())
        np.testing.assert_array_equal(res["mask"], frame.isnan().numpy())
        np.testing.assert_array_equal(res["half"],
                                      frame.to(torch.bfloat16).view(torch.int16).numpy())
    top_of_rank1 = groups[3][1]["halo"]["ext"][0, 0, 1, 1]
    assert top_of_rank1 == np.float32(-0.0).view(np.int32)  # -0.0, not +0.0


@pytest.mark.parametrize("key,match", [
    ("microbatch", "microbatch"),
    ("stream", "not divisible"),
    ("pp_microbatch_dp", "microbatch 1 not divisible by dp=2"),
    ("no_pp_axis", "pp"),
    ("unsupported", "unsupported"),
    ("dp_batch", "not divisible by dp="),
    ("sp_height", "sp=4"),
])
def test_sharded_errors_keep_the_jax_messages(groups, key, match):
    for res in groups[4]:
        assert res["errors"][key] is not None and match in res["errors"][key]


@pytest.mark.parametrize("make,args,match", [
    (make_pp_mesh, (7,), "even device count"),
    (make_pp_mesh, (1,), "even device count"),
    (make_mesh, (4, 3, 1), r"dp\*tp = 3\*1 != n_devices 4"),
    (make_spatial_mesh, (4, 3, 2), r"dp\*sp = 3\*2 != n_devices 4"),
    (make_pp_mesh, (4, 3, 2), r"dp\*pp = 3\*2 != n_devices 4"),
])
def test_mesh_errors_raise_before_any_process_group(make, args, match):
    with pytest.raises(ValueError, match=match):
        make(*args)


def test_mesh_without_a_group_names_torchrun():
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh()


def test_ranks_run_on_the_card_unless_told_cpu():
    """``init_distributed`` (and so ``run_ranks`` and ``--mesh``) puts a rank
    on the card by default, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from semantic_depth_tpu_torch.parallel.mesh import init_distributed

    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed(rank=0, world_size=1)
