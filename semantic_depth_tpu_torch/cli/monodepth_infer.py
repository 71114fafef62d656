"""Monodepth-only disparity inference (port of
``semantic_depth_tpu/cli/monodepth_infer.py``): the flip-averaged disparity
forward (the surface the reference's DepthFrame consumes,
semantic_depth.py:656-678) over one image or a glob, writing
``<name>_disp.png`` and, with ``--save_npy``, the raw disparity as
``<name>_disp.npy``. Frames of one size go to the card in batches.

    python -m semantic_depth_tpu_torch.cli.monodepth_infer --input 'frames/*.png' \\
        --monodepth_checkpoint monodepth.msgpack --save_npy
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np
import torch

from . import common


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Monodepth disparity inference.")
    p.add_argument("--input", required=True, help="image path or glob")
    p.add_argument("--monodepth_checkpoint", default="random",
                   help=".msgpack, a directory or checkpoint prefix beside monodepth.msgpack, "
                        "or 'random'")
    p.add_argument("--monodepth_encoder", default="vgg")
    p.add_argument("--input_height", type=int, default=256)
    p.add_argument("--input_width", type=int, default=512)
    p.add_argument("--out_dir", default="results/disparity")
    p.add_argument("--save_npy", action="store_true",
                   help="also save the raw post-processed disparity array")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--CUDA_DEVICE_NUMBER", default="0", help="the CUDA card to run on")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="'cpu' runs the plain PyTorch path on the CPU (tests)")
    p.add_argument("--dev_tiny", action="store_true", help=argparse.SUPPRESS)
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    from ..models import Monodepth, flip_average_postprocess
    from ..ops.resize import resize_clip_u8
    from ..runtime import resolve_device, set_full_fp32

    dev = resolve_device(common.cli_device(args))
    set_full_fp32()
    hw = (args.input_height, args.input_width)
    with torch.device(dev):
        torch.manual_seed(1)  # 'random' weights: build_pipeline's monodepth seed
        mono = Monodepth(encoder=args.monodepth_encoder,
                         width_mult=0.0625 if args.dev_tiny else 1.0)
    common.load_mono_params(mono, args.monodepth_checkpoint)
    mono = mono.to(dev).eval()

    @torch.inference_mode()
    def infer(frames: np.ndarray) -> np.ndarray:  # (B, H0, W0, 3) BGR uint8
        small = resize_clip_u8(torch.from_numpy(frames).to(dev).float(), hw)
        norm = small / small.new_tensor(255.0)  # a true division on the card too
        b = norm.shape[0]
        disp = mono.disp_left(torch.cat([norm, norm.flip(2)], dim=0))
        return flip_average_postprocess(torch.stack([disp[:b], disp[b:]], dim=1)).cpu().numpy()

    paths = sorted(glob(args.input)) if any(c in args.input for c in "*?[") else [args.input]
    if not paths:
        raise SystemExit(f"no inputs match {args.input}")
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(0, len(paths), args.batch):
        chunk = paths[i:i + args.batch]
        frames = [common.imread_bgr(p) for p in chunk]
        # one batch of a size; mixed sizes go one by one
        groups = [list(zip(chunk, frames))] if len({f.shape for f in frames}) == 1 else [
            [item] for item in zip(chunk, frames)]
        for group in groups:
            disps = infer(np.stack([f for _, f in group]))
            for disp, (src, frame) in zip(disps, group):
                name = os.path.splitext(os.path.basename(src))[0]
                oh, ow = frame.shape[:2]
                common.save_disparity_png(disp, os.path.join(args.out_dir, name), oh, ow)
                if args.save_npy:
                    np.save(os.path.join(args.out_dir, f"{name}_disp.npy"), disp)
                print(f"{src} -> {args.out_dir}/{name}_disp.png")


if __name__ == "__main__":
    main()
