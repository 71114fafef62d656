"""Cityscapes sequence entry point (port of ``semantic_depth_tpu/cli/sequence.py``;
reference semantic_depth_cityscapes_sequence.py:592-705).

Processes a sorted glob of frames with the rw approach by default, writing a
per-frame annotated overlay PNG and a masked-road PLY (with the measurement
line when found), under
``results/<name>/{result_sequence_imgs,result_sequence_ply,rendered_sequence}``.

The card works on frame N+1 while the host writes frame N's artifacts: each
result starts its copy to pinned host memory as soon as it is queued
(``common.fetch``), and the host waits for it only after queueing the next
frame (per frame) or the next batch (``--batch N``). Unreadable frames are
skipped with a warning. ``--use_frozen PATH`` serves from a program of
``cli.export_pipeline`` instead of the live networks.

    python -m semantic_depth_tpu_torch.cli.sequence --input_folder 'frames/*.png' \\
        --semantic_model fcn8s.msgpack --monodepth_checkpoint monodepth.msgpack --batch 4

``--mesh dp|sp|pp`` serves over N ranks (``parallel/``), one process per
mesh position, launched by torchrun; every rank reads the frames, rank 0
alone writes the artifacts:

    torchrun --nproc_per_node 2 -m semantic_depth_tpu_torch.cli.sequence \\
        --input_folder 'frames/*.png' ... --batch 8 --mesh dp
"""

from __future__ import annotations

import argparse
import os
import time
from glob import glob

import numpy as np
import torch.distributed as dist

from ..config import sequence_pipeline_config
from ..io import artifacts as art
from ..io.ply import PlyCloud
from . import common

# what the sequence artifacts read of each frame's outputs
_FIELDS = ("dist_rw", "rw_found", "left_pt_rw", "right_pt_rw", "overlay_small", "road_cloud")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Apply the semantic-depth pipeline to a sequence of frames.")
    p.add_argument("--input_folder", default="data/stuttgart_video/*.png",
                   help="glob of input frames (seq:598-602)")
    p.add_argument("--semantic_model", default="models/sem_seg/30-Epochs-cityscapes")
    p.add_argument("--monodepth_checkpoint",
                   default="models/monodepth/model_cityscapes/model_cityscapes")
    p.add_argument("--monodepth_encoder", type=str, default="vgg",
                   help="type of encoder, vgg, resnet50 or dpt_large")
    p.add_argument("--input_height", type=int, default=256)
    p.add_argument("--input_width", type=int, default=512)
    p.add_argument("--approach", type=str, default="rw")
    p.add_argument("--depth", type=float, default=10)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--batch", type=int, default=1,
                   help="frames per process_batch call (frames of one batch share a "
                        "resolution; a change of resolution starts a new batch)")
    p.add_argument("--output_name", default="stuttgart_video")
    p.add_argument("--results_dir", default="results")
    p.add_argument("--use_frozen", nargs="?", const=None, default=None, metavar="PATH",
                   help="serve from a program written by cli.export_pipeline (its "
                        "export config wins; --batch must be its batch, and a ragged "
                        "tail is padded with the last frame); the bare flag is the "
                        "reference's no-op")
    p.add_argument("--use_xla", action="store_true", help="(compat no-op)")
    p.add_argument("--CUDA_DEVICE_NUMBER", default="0", help="the CUDA card to run on")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="'cpu' runs the plain PyTorch path on the CPU (tests)")
    p.add_argument("--dev_tiny", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--native_s2d", action="store_true",
                   help="use the input_s2d native full-resolution variants "
                        "(space-to-depth packed trunks; needs a matching weight set)")
    p.add_argument("--mesh", choices=("dp", "sp", "pp"), default=None,
                   help="serve over the ranks torchrun launched: dp shards the batch, sp "
                        "the image rows, pp stages the program (2 stages; an even rank "
                        "count); a frozen program serves with dp only")
    return p


def save_sequence_artifacts(out, cfg, output_name, original_hw, result_images_dir,
                            result_ply_dir):
    """``out``: one frame's outputs as numpy arrays. Returns the road width,
    or None when no line was found."""
    line_found = bool(out.rw_found)
    dist_rw = float(out.dist_rw)
    left, right = out.left_pt_rw, out.right_pt_rw

    # full-res annotated overlay (seq:305-346)
    oh, ow = original_hw
    overlay_full = common.host_resize(out.overlay_small.astype(np.float32), oh, ow)
    annotated = common.annotate_sequence(overlay_full, cfg.depth, line_found, dist_rw, left, right)
    common.imwrite(os.path.join(result_images_dir, f"{output_name}.png"), annotated)

    # masked-road PLY + rw line (seq:355-361)
    road_valid = out.road_cloud.valid
    ply = PlyCloud(out.road_cloud.xyz[road_valid], out.road_cloud.rgb[road_valid],
                   os.path.join(result_ply_dir, f"{output_name}_rw"))
    if line_found:
        ply.add(*art.measurement_line(left, right, [250, 0, 0]))
    ply.save()
    return dist_rw if line_found else None


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    cfg = sequence_pipeline_config(input_height=args.input_height, input_width=args.input_width,
                                   approach=args.approach, depth=args.depth)
    cfg = common.apply_encoder_override(cfg, args.monodepth_encoder)
    if args.use_frozen and args.mesh and args.mesh != "dp":
        raise SystemExit("--mesh sp/pp cannot serve a frozen export "
                         "(the program is a per-device unit; only "
                         "batch sharding composes with it); use --mesh dp "
                         "over a batched export, or drop --use_frozen")
    device, own_group = (common.join_mesh(args) if args.mesh
                         else (common.cli_device(args), False))
    n = dist.get_world_size() if args.mesh else 1
    if args.use_frozen:
        mesh = None
        if args.mesh == "dp":
            from ..parallel import make_mesh

            mesh = make_mesh(n, dp=n, tp=1)
        pipe = common.FrozenPipeline(args.use_frozen, cfg, mesh=mesh, device=device)
        if (pipe.batch or 1) != args.batch:
            if mesh is not None:
                raise SystemExit(
                    f"--mesh dp over this frozen export serves batch {pipe.batch} "
                    f"(= export batch x {n} devices); pass --batch {pipe.batch}")
            raise SystemExit(f"--use_frozen: the program serves batches of {pipe.batch or 1}; "
                             f"pass --batch {pipe.batch or 1}")
        cfg = pipe.config  # the program fixes depth, approach and camera
    else:
        pipe = common.build_pipeline(
            cfg, args.semantic_model, args.monodepth_checkpoint,
            tiny=args.dev_tiny, native_s2d=args.native_s2d, device=device)
        if args.mesh:
            pipe = _sharded(pipe, args, n)
    writer = common.is_writer()
    say = print if writer else (lambda *a, **k: None)

    out_root = os.path.join(args.results_dir, args.output_name)
    result_images_dir = os.path.join(out_root, "result_sequence_imgs")
    result_ply_dir = os.path.join(out_root, "result_sequence_ply")
    rendered_dir = os.path.join(out_root, "rendered_sequence")
    if writer:
        for d in (result_images_dir, result_ply_dir, rendered_dir):
            os.makedirs(d, exist_ok=True)

    frames = sorted(glob(args.input_folder))
    if not frames:
        raise SystemExit(f"no frames match {args.input_folder}")

    def load(path):
        try:
            return common.imread_bgr(path)
        except Exception as e:  # a corrupt or unreadable frame: log and go on
            say(f"WARNING: skipping unreadable frame {path}: {e}")
            return None

    def drain(entry):
        names, hws, wait = entry
        outs = wait()
        for i, (name, hw) in enumerate(zip(names, hws)):
            d = save_sequence_artifacts(outs.frame(i), cfg, name, hw, result_images_dir,
                                        result_ply_dir)
            if args.verbose and d is not None:
                say("Road width", d)

    pending = []  # (names, original sizes, fetch wait) of queued batches

    def flush(items):
        """Queue one batch (frames of one size, uint8, cast on the device);
        write the artifacts of the batch before it."""
        if not items:
            return
        names, hws, imgs = zip(*items)
        imgs = list(imgs)
        if (args.use_frozen or args.mesh) and len(imgs) < args.batch:
            # a frozen program is fixed to --batch N, and a sharded one needs
            # a batch that divides over its ranks: pad a ragged tail with the
            # last frame; drain writes only ``names``, the real frames
            imgs += [imgs[-1]] * (args.batch - len(imgs))
        outs = common.require_dense_outputs(pipe.process_batch(np.stack(imgs)),
                                            "the sequence artifact suite")
        if writer:
            pending.append((names, hws, common.fetch(outs, _FIELDS)))
        while len(pending) > 1:
            drain(pending.pop(0))

    items = []
    done = 0
    t0 = time.perf_counter()
    for path, frame in common.prefetch_decoded(frames, load):
        if frame is None:
            continue
        say(f"\n\nPROCESSING NEW FRAME! {path}\n")
        done += 1
        name = os.path.splitext(os.path.basename(path))[0]
        if items and frame.shape[:2] != items[0][2].shape[:2]:
            flush(items)
            items = []
        items.append((name, frame.shape[:2], frame))
        if len(items) == args.batch:
            flush(items)
            items = []
    flush(items)
    for entry in pending:
        drain(entry)
    secs = time.perf_counter() - t0
    say(f"{done} frames in {secs:.3f} s ({secs / max(done, 1):.4f} s per frame, "
        "decode and artifacts included)")
    common.leave_mesh(own_group)


def _sharded(pipe, args, n):
    """The live pipeline over the mesh ``--mesh`` names, with the JAX CLI's
    checks (n ranks)."""
    from ..parallel import (PipelinedPipeline, ShardedPipeline, make_mesh, make_pp_mesh,
                            make_spatial_mesh)

    if args.mesh == "dp":
        if args.batch % n != 0:
            raise SystemExit(f"--mesh dp shards the batch over {n} devices; "
                             f"--batch {args.batch} must be a multiple of {n}")
        return ShardedPipeline(pipe, make_mesh(n, dp=n, tp=1))
    if args.mesh == "pp":
        if n < 2 or n % 2 != 0:
            raise SystemExit(f"--mesh pp stages the pipeline across chips; needs an "
                             f"even device count >= 2, got {n}")
        # each microbatch shards over dp = n/2 (process_batch picks the
        # microbatch count)
        if args.batch % (n // 2) != 0:
            raise SystemExit(f"--mesh pp microbatches over dp={n // 2} devices x 2 "
                             f"stages; --batch {args.batch} must be a multiple of {n // 2}")
        return PipelinedPipeline(pipe, make_pp_mesh(n, dp=n // 2, pp=2))
    return ShardedPipeline(pipe, make_spatial_mesh(n))


if __name__ == "__main__":
    main()
