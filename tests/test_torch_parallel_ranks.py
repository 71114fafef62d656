"""What each rank runs in tests/test_torch_parallel.py,
tests/test_torch_parallel_cli.py, tests/test_torch_parallel_train.py and
tests/test_torch_cuda.py
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


# --- multi-device training (tests/test_torch_parallel_train.py) ------------------------


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def replica_digests(trainer):
    """Hashes of what this rank holds: the replicated parameters with their
    Adam moments, and its blocks of the tp-split ones with theirs."""
    from semantic_depth_tpu_torch.parallel.train_step import SPLIT_DIMS

    parts = {True: [], False: []}
    for name, p in trainer.model.named_parameters():
        st = trainer.optimizer.state[p]
        parts[name in SPLIT_DIMS] += [p, st["exp_avg"], st["exp_avg_sq"]]
    return dict(replicated=_sha(parts[False]), blocks=_sha(parts[True]))


def flat(state) -> dict:
    """A full state dict as ``torch_helpers.flax_flat`` keys and layouts."""
    out = {}
    for name, t in state.items():
        layer, kind = name.rsplit(".", 1)
        t = t.detach().cpu().clone()
        out[f"{layer}.{'kernel' if kind == 'weight' else 'bias'}"] = (
            t.permute(2, 3, 1, 0) if kind == "weight" else t).numpy()
    return out


def fcn_trainer(spec, mesh=None, keep=1.0, seed=0, batch_size=None, device="cpu"):
    from semantic_depth_tpu_torch.config import TrainConfig
    from semantic_depth_tpu_torch.train.trainer import FCNTrainer

    cfg = TrainConfig(learning_rate=spec["lr"], image_shape=spec["hw"], epochs=1,
                      batch_size=batch_size or len(spec["images"]))
    return FCNTrainer(cfg, model=FCN8s(num_classes=3, dropout_keep_prob=keep, **spec["fcn_kw"]),
                      init_params=spec["params"], seed=seed, device=device, mesh=mesh)


def full_step(trainer, mesh, images, labels):
    """One train step and what the tests compare of it: the metrics, and the
    gathered gradients and parameters (``flat`` layout, numpy)."""
    from semantic_depth_tpu_torch.parallel.train_step import gather_state_dict

    m = trainer.train_batch(images, labels)
    named = dict(trainer.model.named_parameters())
    grads = {k: p.grad for k, p in named.items()}
    if mesh is not None:
        named, grads = gather_state_dict(mesh, named), gather_state_dict(mesh, grads)
    return dict(loss=m["loss"], cm=m["cm"], grads=flat(grads), params=flat(named))


class _RaggedData:
    """A dataset of one full and one ragged train batch, one val batch."""

    def __init__(self, images, labels):
        self.images, self.labels = images, labels

    def num_images(self, mode):
        return len(self.images) + 3 if mode == "train" else len(self.images)

    def batches(self, batch_size, mode="train"):
        yield self.images, self.labels
        if mode == "train":
            yield self.images[:3], self.labels[:3]


def fcn_mesh_cases(spec):
    """The sharded FCN-8s trainer on each (dp, tp) of ``spec["meshes"]``:
    two steps at keep 1.0 (rank 0 returns them), the replicas' digests, a
    checkpoint after step 1, ``set_params``, a resumed single-process
    checkpoint, two steps at keep 0.5, the ragged-batch errors and ``fit``'s
    drop; rank 0 also runs the single-process trainer at keep 0.5."""
    import contextlib
    import io
    import os

    import numpy as np
    import torch.distributed as dist

    from semantic_depth_tpu_torch.parallel.train_step import gather_fcn_params, shard_fcn_params

    torch.set_num_threads(1)
    rank, n = dist.get_rank(), dist.get_world_size()
    images, labels = spec["images"], spec["labels"]
    out = {}
    if rank == 0:
        single = fcn_trainer(spec, keep=0.5, seed=3)
        out["single_keep05"] = [single.train_batch(images, labels)["loss"] for _ in range(2)]
    for dp, tp in spec["meshes"]:
        mesh = make_mesh(n, dp=dp, tp=tp)
        t = fcn_trainer(spec, mesh)
        steps = [full_step(t, mesh, images, labels)]
        t.save_checkpoint(os.path.join(spec["dir"], f"{dp}x{tp}"))
        steps.append(full_step(t, mesh, images, labels))
        res = dict(digests=replica_digests(t), tp_rank=mesh.get_local_rank("tp"))
        t.set_params(spec["params"])
        again = full_step(t, mesh, images, labels)
        r = fcn_trainer(spec, mesh)
        r.restore_checkpoint(spec["single_ckpt"], 1)
        resumed = full_step(r, mesh, images, labels)
        k = fcn_trainer(spec, mesh, keep=0.5, seed=3)
        res["keep05"] = [k.train_batch(images, labels)["loss"] for _ in range(2)]
        res["ragged"] = raised(t.train_batch, images[:3], labels[:3])
        # a flax tree sharded into a full-shape module and gathered back
        tree = gather_fcn_params(mesh, shard_fcn_params(mesh, spec["params"],
                                                        FCN8s(num_classes=3, **spec["fcn_kw"])))
        res["tree_round_trip"] = all(
            np.array_equal(tree["params"][layer][kind], v)
            for layer, leaf in spec["params"]["params"].items() for kind, v in leaf.items())
        fcn_trainer(spec, mesh, batch_size=1)  # test mode's construction
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            hist = t.fit(_RaggedData(images, labels), verbose=True)
        res.update(fit_printed=printed.getvalue(), fit_step=t.step,
                   fit_loss=hist["train_loss"][0])
        if rank == 0:
            res.update(steps=steps, again=again, resumed=resumed)
        out[(dp, tp)] = res
    return out


def mono_mesh_case(spec):
    """``MonodepthTrainer(mesh)`` over every rank (dp = world): two steps
    (rank 0 returns them), the replicas' digest and the ragged-batch
    error."""
    import torch.distributed as dist

    from semantic_depth_tpu_torch.train.monodepth_trainer import (MonodepthTrainConfig,
                                                                  MonodepthTrainer)

    torch.set_num_threads(1)
    n = dist.get_world_size()
    mesh = make_mesh(n, dp=n, tp=1)
    t = MonodepthTrainer(MonodepthTrainConfig(learning_rate=spec["lr"]),
                         model=Monodepth(encoder="vgg", **spec["mono_kw"]),
                         init_params=spec["mono_params"], device="cpu", mesh=mesh)
    left, right = spec["left"], spec["right"]
    steps = []
    for _ in range(2):
        m = t.train_batch(left, right)
        named = dict(t.model.named_parameters())
        steps.append(dict(metrics=m, grads=flat({k: p.grad for k, p in named.items()}),
                          params=flat(named)))
    res = dict(digest=replica_digests(t)["replicated"],
               ragged=raised(t.train_batch, left[:3], right[:3]))
    if dist.get_rank() == 0:
        res["steps"] = steps
    return res


def fcn_steps_on_card(spec):
    """The sharded FCN-8s trainer on meshes (1, 2) and (2, 1) of the ranks
    sharing this host's card, two steps at keep 0.5 with deterministic
    cuDNN: its losses and replica digests; rank 0 also returns the
    single-process trainer's losses on the card."""
    import torch.distributed as dist

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dev = torch.device("cuda", torch.cuda.current_device())
    images, labels = spec["images"], spec["labels"]
    out = dict(backend=str(dist.get_backend()))
    if dist.get_rank() == 0:
        single = fcn_trainer(spec, keep=0.5, seed=3, device=dev)
        out["single"] = [single.train_batch(images, labels)["loss"] for _ in range(2)]
    for dp, tp in ((1, 2), (2, 1)):
        t = fcn_trainer(spec, make_mesh(dist.get_world_size(), dp=dp, tp=tp), keep=0.5, seed=3,
                        device=dev)
        out[(dp, tp)] = dict(losses=[t.train_batch(images, labels)["loss"] for _ in range(2)],
                             digests=replica_digests(t))
    return out
