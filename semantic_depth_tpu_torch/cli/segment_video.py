"""Video segmentation (port of ``semantic_depth_tpu/cli/segment_video.py``; the
reference's fcn8s/segment_video_robo.py:45-202 imports a module that does
not exist and hardcodes its model paths, so this is a working equivalent).

Segments every frame of a video with FCN-8s and writes the overlay video:
cv2 decodes and encodes on the host; resize, segmentation and overlay run on
the card, one batch of frames at a time.

    python -m semantic_depth_tpu_torch.cli.segment_video --input_video in.mp4 \\
        --semantic_model fcn8s.msgpack --output_video out.mp4
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import common

# the overlay colors of the reference video script (and of the JAX CLI)
_ROAD_RGBA, _FENCE_RGBA = (128, 64, 128, 64), (160, 10, 10, 64)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Segment a video with FCN-8s.")
    p.add_argument("--input_video", required=True)
    p.add_argument("--output_video", default=None)
    p.add_argument("--semantic_model", default="models/sem_seg/100-Epochs-roborace750")
    p.add_argument("--input_height", type=int, default=256)
    p.add_argument("--input_width", type=int, default=512)
    p.add_argument("--batch", type=int, default=8, help="frames per batch on the card")
    p.add_argument("--CUDA_DEVICE_NUMBER", default="0", help="the CUDA card to run on")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="'cpu' runs the plain PyTorch path on the CPU (tests)")
    p.add_argument("--dev_tiny", action="store_true", help=argparse.SUPPRESS)
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    import cv2

    from ..models import FCN8s
    from ..ops.overlay import segmentation_overlay
    from ..ops.resize import resize_clip_u8
    from ..runtime import resolve_device, set_full_fp32

    dev = resolve_device(common.cli_device(args))
    set_full_fp32()
    hw = (args.input_height, args.input_width)
    kw = dict(width_mult=0.0625, fc_channels=32) if args.dev_tiny else {}
    with torch.device(dev):
        torch.manual_seed(0)  # 'random' weights: build_pipeline's FCN-8s seed
        fcn = FCN8s(num_classes=3, **kw)
    common.load_fcn_params(fcn, args.semantic_model)
    fcn = fcn.to(dev).eval()

    @torch.inference_mode()
    def overlays(frames: np.ndarray) -> np.ndarray:  # (B, H0, W0, 3) BGR uint8
        small = resize_clip_u8(torch.from_numpy(frames).to(dev).float(), hw)
        probs = torch.softmax(fcn(small), dim=-1)
        return segmentation_overlay(small, probs[..., 0] > 0.5, probs[..., 1] > 0.5,
                                    _ROAD_RGBA, _FENCE_RGBA).cpu().numpy()

    cap = cv2.VideoCapture(args.input_video)
    if not cap.isOpened():
        raise SystemExit(f"cannot open {args.input_video}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30
    out_path = args.output_video or (os.path.splitext(args.input_video)[0] + "_seg.mp4")
    writer = None
    n_frames = 0

    def flush(batch):
        nonlocal writer, n_frames
        if not batch:
            return
        for src, ov in zip(batch, overlays(np.stack(batch))):
            full = common.host_resize(ov, src.shape[0], src.shape[1])
            if writer is None:
                writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                         (src.shape[1], src.shape[0]))
            writer.write(np.clip(full, 0, 255).astype(np.uint8))
            n_frames += 1

    batch = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        batch.append(frame)
        if len(batch) == args.batch:
            flush(batch)
            batch = []
    flush(batch)
    cap.release()
    if writer is not None:
        writer.release()
    print(f"wrote {n_frames} frames to {out_path}")
    return n_frames


if __name__ == "__main__":
    main()
