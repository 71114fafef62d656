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
"""

from __future__ import annotations

import argparse
import os
import time
from glob import glob

import numpy as np

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
    p.add_argument("--monodepth_encoder", type=str, default="vgg")
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
                   help="multi-device serving is not ported yet")
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
    common.reject_queued_flags(args)
    cfg = sequence_pipeline_config(input_height=args.input_height, input_width=args.input_width,
                                   approach=args.approach, depth=args.depth)
    cfg = common.apply_encoder_override(cfg, args.monodepth_encoder)
    if args.use_frozen:
        pipe = common.FrozenPipeline(args.use_frozen, cfg, device=common.cli_device(args))
        if (pipe.batch or 1) != args.batch:
            raise SystemExit(f"--use_frozen: the program serves batches of {pipe.batch or 1}; "
                             f"pass --batch {pipe.batch or 1}")
        cfg = pipe.config  # the program fixes depth, approach and camera
    else:
        pipe = common.build_pipeline(
            cfg, args.semantic_model, args.monodepth_checkpoint,
            tiny=args.dev_tiny, native_s2d=args.native_s2d, device=common.cli_device(args))

    out_root = os.path.join(args.results_dir, args.output_name)
    result_images_dir = os.path.join(out_root, "result_sequence_imgs")
    result_ply_dir = os.path.join(out_root, "result_sequence_ply")
    rendered_dir = os.path.join(out_root, "rendered_sequence")
    for d in (result_images_dir, result_ply_dir, rendered_dir):
        os.makedirs(d, exist_ok=True)

    frames = sorted(glob(args.input_folder))
    if not frames:
        raise SystemExit(f"no frames match {args.input_folder}")

    def load(path):
        try:
            return common.imread_bgr(path)
        except Exception as e:  # a corrupt or unreadable frame: log and go on
            print(f"WARNING: skipping unreadable frame {path}: {e}")
            return None

    def drain(entry):
        names, hws, wait = entry
        outs = wait()
        for i, (name, hw) in enumerate(zip(names, hws)):
            d = save_sequence_artifacts(outs.frame(i), cfg, name, hw, result_images_dir,
                                        result_ply_dir)
            if args.verbose and d is not None:
                print("Road width", d)

    pending = []  # (names, original sizes, fetch wait) of queued batches

    def flush(items):
        """Queue one batch (frames of one size, uint8, cast on the device);
        write the artifacts of the batch before it."""
        if not items:
            return
        names, hws, imgs = zip(*items)
        imgs = list(imgs)
        if args.use_frozen and len(imgs) < args.batch:
            # a frozen program is fixed to --batch N: pad a ragged tail with
            # the last frame; drain writes only ``names``, the real frames
            imgs += [imgs[-1]] * (args.batch - len(imgs))
        outs = common.require_dense_outputs(pipe.process_batch(np.stack(imgs)),
                                            "the sequence artifact suite")
        pending.append((names, hws, common.fetch(outs, _FIELDS)))
        while len(pending) > 1:
            drain(pending.pop(0))

    items = []
    done = 0
    t0 = time.perf_counter()
    for path, frame in common.prefetch_decoded(frames, load):
        if frame is None:
            continue
        print(f"\n\nPROCESSING NEW FRAME! {path}\n")
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
    print(f"{done} frames in {secs:.3f} s ({secs / max(done, 1):.4f} s per frame, "
          "decode and artifacts included)")


if __name__ == "__main__":
    main()
