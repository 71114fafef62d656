"""What each rank runs in tests/test_torch_parallel.py,
tests/test_torch_parallel_cli.py and tests/test_torch_cuda.py
(``parallel.launch.run_ranks`` imports this module by name in every rank).
It holds no test of its own, and imports torch and the port only: the
ranks start fast and never load JAX."""

import hashlib

import torch

from semantic_depth_tpu_torch import pipeline as tpipeline
from semantic_depth_tpu_torch.models import FCN8s, Monodepth
from semantic_depth_tpu_torch.parallel import (PipelinedPipeline, ShardedPipeline, comm,
                                               make_mesh, make_pp_mesh, make_spatial_mesh)

# what the tests compare of each sharded run
FIELDS = ("disparity", "dist_rw", "dist_f2f", "rw_found", "road_mask", "fence_mask",
          "frame_small", "points3d")


def build_pipeline(spec):
    """The port's pipeline on the CPU from a spec the test process made:
    the config, the networks' constructor arguments and state dicts."""
    fcn = FCN8s(**spec["fcn_kw"])
    fcn.load_state_dict(spec["fcn_state"])
    mono = Monodepth(**spec["mono_kw"])
    mono.load_state_dict(spec["mono_state"])
    return tpipeline.SemanticDepthPipeline(spec["config"], fcn, mono, device="cpu")


def digest(out) -> str:
    """A hash of every tensor of a FrameOutputs, to show two ranks hold the
    same bits."""
    h = hashlib.sha256()
    for t in out.leaves():
        h.update(t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _mesh(kind, n, dp):
    if kind == "dp":
        return make_mesh(n, dp=n, tp=1)
    if kind == "sp":
        return make_spatial_mesh(n, dp=dp)
    return make_pp_mesh(n, dp=dp, pp=n // dp)


def run_cases(cases, specs):
    """Each case on every rank; rank 0 returns the compared fields as numpy,
    and every rank the digest of what it got and its collectives' traffic."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    n = dist.get_world_size()
    pipes = {}
    results = {}
    for case in cases:
        if case["kind"] == "errors":
            results[case["name"]] = run_errors(specs[case["pipe"]], case["frames"])
            continue
        if case["kind"] == "halo":
            results[case["name"]] = run_halo(*case["args"])
            continue
        key = case["pipe"]
        if key not in pipes:
            pipes[key] = build_pipeline(specs[key])
        pipe = pipes[key]
        mesh = _mesh(case["kind"], n, case.get("dp", 1))
        comm.traffic.reset()
        frames, mult = case["frames"], case.get("disparity_mult")
        if case["kind"] == "pp":
            out = PipelinedPipeline(pipe, mesh).process_stream(frames, case["microbatch"],
                                                               disparity_mult=mult)
        else:
            out = ShardedPipeline(pipe, mesh).process_batch(frames, disparity_mult=mult)
        res = dict(digest=digest(out), traffic=comm.traffic.as_dict())
        if dist.get_rank() == 0:
            res["out"] = {f: getattr(out, f).numpy() for f in FIELDS}
        results[case["name"]] = res
    return results


def raised(fn, *args, **kw):
    """The ValueError message ``fn`` raises, or None."""
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


def run_errors(spec, frames):
    """The JAX tests' ValueErrors on a group of 4 ranks."""
    pipe = build_pipeline(spec)
    staged = PipelinedPipeline(pipe, make_pp_mesh(4, dp=2, pp=2))
    dp4 = ShardedPipeline(pipe, make_mesh(4, dp=4, tp=1))
    sp4 = ShardedPipeline(pipe, make_spatial_mesh(4))
    return dict(
        microbatch=raised(staged.process_stream, frames, microbatch=6),
        stream=raised(staged.process_stream, frames[:6], microbatch=4),
        pp_microbatch_dp=raised(staged.process_stream, frames, microbatch=1),
        no_pp_axis=raised(PipelinedPipeline, pipe, make_mesh(4)),
        unsupported=raised(PipelinedPipeline, pipe, make_pp_mesh(4, dp=1, pp=4)),
        dp_batch=raised(dp4.process_batch, frames[:3]),
        sp_height=raised(sp4.process_batch, frames[:1, :250]),
    )


def halo_blocks(rows_per_rank):
    """This rank's block of a (1, 2, R, 3) float32 frame whose row r holds
    r * 10 + column, with -0.0 in every block's last row and nan in every
    block's first row (the rows the neighbours take)."""
    import torch.distributed as dist

    rank = dist.get_rank()
    return halo_frame(dist.get_world_size() * rows_per_rank)[
        :, :, rank * rows_per_rank:(rank + 1) * rows_per_rank]


def halo_frame(rows):
    x = torch.arange(rows, dtype=torch.float32)[:, None] * 10 + torch.arange(3.0)
    x = x.expand(1, 2, rows, 3).clone()
    x[:, 0, 4::5, 1] = -0.0  # the last row of each 5-row block
    x[:, 1, 0::5, 2] = float("nan")  # the first row of each block
    return x


def run_halo(rows_per_rank, top, bottom):
    """``comm.halo_rows`` and ``comm.all_gather_dim`` on this rank's block,
    as raw bits, with bool and bfloat16 gathers."""
    x = halo_blocks(rows_per_rank)
    ext = comm.halo_rows(x, top, bottom, None)
    whole = comm.all_gather_dim(x, 2, None)
    mask = comm.all_gather_dim(x.isnan(), 2, None)
    half = comm.all_gather_dim(x.to(torch.bfloat16), 2, None)
    return dict(ext=ext.view(torch.int32).numpy(), whole=whole.view(torch.int32).numpy(),
                mask=mask.numpy(), half=half.view(torch.int16).numpy())


def run_steps(steps):
    """Several of this module's rank functions in one group: ``steps`` is a
    list of (function name, args); returns their results in order."""
    torch.set_num_threads(1)
    return [globals()[name](*args) for name, args in steps]


def run_cli(module, argv, workdirs):
    """A CLI's ``main`` on this rank (the group is already joined), in this
    rank's own working directory, so that what each rank writes lands
    apart; returns the SystemExit message, or None."""
    import importlib
    import os

    import torch.distributed as dist

    here = os.getcwd()
    os.chdir(workdirs[dist.get_rank()])
    try:
        importlib.import_module(module).main(argv)
    except SystemExit as e:
        return str(e)
    finally:
        os.chdir(here)
    return None


def run_frozen(path, frames, focal, mult):
    """``export.load_pipeline_sharded`` of a batch-1 program on a dp mesh:
    the gathered outputs and the errors."""
    import torch.distributed as dist

    from semantic_depth_tpu_torch.export import load_pipeline_sharded

    mesh = make_mesh(dist.get_world_size(), dp=dist.get_world_size(), tp=1)
    call = load_pipeline_sharded(path, mesh)
    out = call(frames, focal, mult)
    return dict(global_batch=call.global_batch, digest=digest(out),
                out={f: getattr(out, f).numpy() for f in FIELDS},
                wrong_batch=raised(call, frames[:1], focal, mult))


def run_frozen_single(path):
    """The error of ``load_pipeline_sharded`` over a single-frame program."""
    import torch.distributed as dist

    from semantic_depth_tpu_torch.export import load_pipeline_sharded

    mesh = make_mesh(dist.get_world_size(), dp=dist.get_world_size(), tp=1)
    return raised(load_pipeline_sharded, path, mesh)


def run_frozen_other_device(path):
    """``cli.common.FrozenPipeline`` on a dp mesh, asked to serve a CPU
    export on a card: the SystemExit message (the single-device path's)."""
    import torch.distributed as dist

    from semantic_depth_tpu_torch import config
    from semantic_depth_tpu_torch.cli.common import FrozenPipeline

    mesh = make_mesh(dist.get_world_size(), dp=dist.get_world_size(), tp=1)
    try:
        FrozenPipeline(path, config.munich_pipeline_config(), mesh=mesh, device="cuda:0")
    except SystemExit as e:
        return str(e)
    return None


def run_dp_on_card(frames):
    """dp over the ranks sharing this host's card, tiny networks, with
    deterministic cuDNN: the digests of the gathered outputs, of this
    rank's shard of them and of the single-process ``process_batch`` of the
    same frames."""
    import torch.distributed as dist

    from semantic_depth_tpu_torch import config
    from semantic_depth_tpu_torch.cli.common import build_pipeline

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = config.munich_pipeline_config(input_height=128, input_width=256)
    pipe = build_pipeline(cfg, "random", "random", tiny=True,
                          device=torch.device("cuda", torch.cuda.current_device()))
    out = ShardedPipeline(pipe, make_mesh(world, dp=world, tp=1)).process_batch(frames)
    per = len(frames) // world
    ref = pipe.process_batch(frames[rank * per:(rank + 1) * per])
    return dict(backend=str(dist.get_backend()), digest=digest(out), ref=digest(ref),
                shard=digest(out.map(lambda x: x[rank * per:(rank + 1) * per])))
