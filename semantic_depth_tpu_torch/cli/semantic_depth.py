"""Single-frame entry point + Munich focal-length sweep (port of
``semantic_depth_tpu/cli/semantic_depth.py``; reference semantic_depth.py:700-1018).

* ``--input_frame`` processes one image end to end and writes its distances,
  stage times and, with ``--save_data``, the artifact suite;
* ``--input_frame=''`` runs the 5-image Munich sweep over focal lengths
  [380, 580] with MAE accounting and best-focal reporting; ``--f`` pins a
  single focal length;
* ``--use_frozen PATH`` serves from a program of ``cli.export_pipeline``
  (every focal of the sweep through the one program).

Runs on the card (``--CUDA_DEVICE_NUMBER`` picks it) unless ``--device cpu``:

    python -m semantic_depth_tpu_torch.cli.semantic_depth --input_frame f.png \\
        --semantic_model fcn8s.msgpack --monodepth_checkpoint monodepth.msgpack --save_data

``--mesh sp`` splits each frame's rows over the ranks torchrun launched
(``parallel/``; rank 0 alone writes):

    torchrun --nproc_per_node 2 -m semantic_depth_tpu_torch.cli.semantic_depth \\
        --input_frame f.png ... --mesh sp
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from ..config import cityscapes_pipeline_config, munich_pipeline_config
from ..io import artifacts as art
from . import common

# Munich hand-measured road widths at 10 m (semantic_depth.py:837).
MUNICH_GROUND_TRUTH = {
    "test_1.png": 5.3,
    "test_2.png": 4.4,
    "test_3.png": 5.4,
    "test_4.png": 3.1,
    "test_5.png": 4.6,
}
SWEEP_FOCALS = [380, 580]  # semantic_depth.py:854


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Read frame and compute the distance from the center "
        "of the car to the fences (PyTorch/CUDA port).")
    p.add_argument("--input_folder", default="data/test_images_munich")
    p.add_argument("--input_frame", default="data/test_images_munich/test_3.png",
                   help="COMPLETE path to one frame; set to '' to run the sweep")
    p.add_argument("--semantic_model", default="models/sem_seg/100-Epochs-roborace750",
                   help="FCN-8s weights: .msgpack, a dir holding fcn8s.msgpack, or 'random'")
    p.add_argument("--monodepth_checkpoint",
                   default="models/monodepth/model_cityscapes/model_cityscapes",
                   help="monodepth weights: .msgpack, a dir or checkpoint prefix beside "
                        "monodepth.msgpack, or 'random'")
    p.add_argument("--monodepth_encoder", type=str, default="vgg",
                   help="type of encoder, vgg or resnet50")
    p.add_argument("--input_height", type=int, default=256)
    p.add_argument("--input_width", type=int, default=512)
    p.add_argument("--approach", type=str, default="both")
    p.add_argument("--depth", type=float, default=10)
    p.add_argument("--f", type=float, default=None,
                   help="focal length; None sweeps [380, 580] in series mode")
    p.add_argument("--save_data", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--is_city", action="store_true")
    p.add_argument("--results_dir", default="results")
    p.add_argument("--use_frozen", nargs="?", const=None, default=None, metavar="PATH",
                   help="serve from a program written by cli.export_pipeline (its "
                        "export config wins); the bare flag is the reference's no-op")
    p.add_argument("--use_xla", action="store_true", help="(compat no-op)")
    p.add_argument("--CUDA_DEVICE_NUMBER", default="0", help="the CUDA card to run on")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="'cpu' runs the plain PyTorch path on the CPU (tests)")
    p.add_argument("--profile_stages", action="store_true",
                   help="run stage by stage with a device sync between stages so "
                        "_times.txt carries real per-stage wall times (slower)")
    p.add_argument("--dev_tiny", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--native_s2d", action="store_true",
                   help="use the input_s2d native full-resolution variants "
                        "(space-to-depth packed trunks; needs a matching weight set)")
    p.add_argument("--mesh", choices=("sp",), default=None,
                   help="split each frame's rows over the ranks torchrun launched "
                        "(single-frame latency)")
    return p


def make_config(args):
    base = cityscapes_pipeline_config if args.is_city else munich_pipeline_config
    cfg = base(input_height=args.input_height, input_width=args.input_width,
               approach=args.approach, depth=args.depth)
    cfg = common.apply_encoder_override(cfg, args.monodepth_encoder)
    if args.f is not None:
        cfg = dataclasses.replace(cfg, camera=cfg.camera.with_focal(args.f))
    return cfg


def process_one(pipe, cfg, input_frame, output_name, args, focal=None):
    """Run one frame; write times/distances and optionally the artifact suite.
    Returns (dist_rw, dist_f2f)."""
    tic_global = time.time()
    tic = time.time()
    frame = common.imread_bgr(input_frame)
    t_read = time.time() - tic

    tic = time.time()
    stage_times = None
    # frames ship uint8; the frame program casts on the device
    if args.profile_stages:
        out, stage_times = pipe.process_frame_staged(frame, focal=focal)
    else:
        out = pipe.process_frame(frame, focal=focal)
    if args.save_data:
        common.require_dense_outputs(out, "--save_data")
    fields = None if args.save_data else ("dist_rw", "dist_f2f")
    out = common.fetch(out, fields)()
    dist_rw = float(out.dist_rw)
    dist_f2f = float(out.dist_f2f)
    t_device = time.time() - tic

    if args.verbose:
        print("Road width", dist_rw)
        if cfg.approach == "both":
            print("Distance from fence to fence:", dist_f2f)

    writer = common.is_writer()
    if args.save_data and writer:
        common.save_frame_artifacts(out, cfg, output_name, frame, args.is_city)

    t_global = time.time() - tic_global
    if stage_times is not None:
        times = dict(stage_times)
        times["read"] = t_read + times.get("read", 0.0)
        times["global"] = t_global
    else:
        # the fused program has no per-stage host boundaries to time; the
        # stage labels stay for the reference's file format
        times = {"read": t_read, "semantic": t_device, "disparity": 0.0, "to3D": 0.0,
                 "road": 0.0, "rw": 0.0, "fences": 0.0, "f2f": 0.0, "global": t_global}
    if writer:
        art.write_times(output_name, times)
        art.write_distances(output_name, dist_rw, dist_f2f)
    return dist_rw, dist_f2f


def _output_paths(results_root: str, input_frame: str):
    output_name = os.path.splitext(os.path.basename(input_frame))[0]
    output_directory = os.path.join(results_root, output_name)
    if common.is_writer():
        os.makedirs(output_directory, exist_ok=True)
    return output_directory, os.path.join(output_directory, f"{output_name}_output")


def run_sweep(pipe, cfg, args, focal_lengths):
    best = {"rw": (-1, None), "f2f": (-1, None), "overall": (-1, None)}
    for f in focal_lengths:
        f_directory = os.path.join(args.results_dir, str(f))
        if common.is_writer():
            os.makedirs(f_directory, exist_ok=True)
        all_data = []
        for fname, real_distance in sorted(MUNICH_GROUND_TRUTH.items()):
            input_frame = os.path.join(args.input_folder, fname)
            print(f"#####    focal length: {f} - image: {fname}"
                  f" (real distance at 10 m: {real_distance})")
            _, output_name = _output_paths(f_directory, input_frame)
            dist_rw, dist_f2f = process_one(pipe, cfg, input_frame, output_name, args, focal=f)
            all_data.append((real_distance, dist_rw, dist_f2f,
                             abs(real_distance - dist_rw), abs(real_distance - dist_f2f)))
        data = np.asarray(all_data)
        if common.is_writer():
            art.write_sweep_data(f_directory, data, len(MUNICH_GROUND_TRUTH))
        mae_rw = data[:, 3].sum() / len(MUNICH_GROUND_TRUTH)
        mae_f2f = data[:, 4].sum() / len(MUNICH_GROUND_TRUTH)
        for key, mae in (("rw", mae_rw), ("f2f", mae_f2f), ("overall", mae_rw + mae_f2f)):
            if best[key][0] == -1 or mae < best[key][0]:
                best[key] = (mae, f)
        print(f"Data saved for focal length: {f}")
    if len(focal_lengths) > 1 and common.is_writer():
        art.write_best_focal_lengths(
            args.results_dir, best["rw"][1], best["f2f"][1], best["overall"][1])
        print("Best focal lengths file generated!")


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    cfg = make_config(args)
    if args.use_frozen:
        if args.profile_stages:
            raise SystemExit("--profile_stages needs the live pipeline; the frozen program "
                             "is one opaque program")
        if args.mesh:
            raise SystemExit("--mesh cannot serve a frozen export "
                             "(the program is one single-device program); "
                             "drop --use_frozen or --mesh")
    if args.mesh and args.profile_stages:
        raise SystemExit("--profile_stages times the single-device "
                         "stage programs; drop it or --mesh")
    device, own_group = (common.join_mesh(args) if args.mesh
                         else (common.cli_device(args), False))
    if args.use_frozen:
        pipe = common.FrozenPipeline(args.use_frozen, cfg, device=device)
    else:
        pipe = common.build_pipeline(
            cfg, args.semantic_model, args.monodepth_checkpoint,
            tiny=args.dev_tiny, native_s2d=args.native_s2d, device=device)
    if args.mesh:
        from ..parallel import ShardedPipeline, make_spatial_mesh

        pipe = ShardedPipeline(pipe, make_spatial_mesh())
    # a frozen program fixes depth, approach and camera: the artifacts and
    # annotations describe what it computes
    cfg = pipe.config

    if args.input_frame:
        print("##########################################################")
        print(f"##### {args.input_frame} - focal length: {args.f}  #####")
        print("##########################################################")
        _, output_name = _output_paths(args.results_dir, args.input_frame)
        dist_rw, dist_f2f = process_one(pipe, cfg, args.input_frame, output_name, args,
                                        focal=args.f)
        print(f"rw: {dist_rw:.4f} m   f2f: {dist_f2f:.4f} m")
    else:
        focals = [args.f] if args.f is not None else SWEEP_FOCALS
        run_sweep(pipe, cfg, args, focals)
    common.leave_mesh(own_group)


if __name__ == "__main__":
    main()
