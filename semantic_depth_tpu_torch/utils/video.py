"""Assemble result frames into an mp4 (port of ``semantic_depth_tpu/utils/video.py``;
reference utils/create_video_from_frames.py:1-30: cv2.VideoWriter at 30 fps
over the sorted result_sequence_imgs PNGs). Host-side: cv2 only.

    python -m semantic_depth_tpu_torch.utils.video --frames 'imgs/*.png' --output v.mp4
"""

from __future__ import annotations

import argparse
import os
from glob import glob


def create_video_from_frames(frames_glob: str, output_path: str, fps: int = 30) -> str:
    import cv2

    paths = sorted(glob(frames_glob))
    if not paths:
        raise FileNotFoundError(f"no frames match {frames_glob}")
    first = cv2.imread(paths[0])
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for p in paths:
        img = cv2.imread(p)
        if img.shape[:2] != (h, w):
            img = cv2.resize(img, (w, h))
        writer.write(img)
    writer.release()
    return output_path


def main(argv=None):
    p = argparse.ArgumentParser(description="Create an mp4 from result frames.")
    p.add_argument("--frames", default="results/stuttgart_video/result_sequence_imgs/*.png")
    p.add_argument("--output", default="results/stuttgart_video/video.mp4")
    p.add_argument("--fps", type=int, default=30)
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    print(f"wrote {create_video_from_frames(args.frames, args.output, args.fps)}")


if __name__ == "__main__":
    main()
