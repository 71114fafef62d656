"""Monodepth stereo-training entry point (port of
``semantic_depth_tpu/cli/monodepth_train.py``).

Trains on stereo pairs with the published recipe: a KITTI/Cityscapes
filename-list loader (or a left/ right/ directory pair), random
flip-and-swap + gamma/brightness/color jitter, and a prefetching host
pipeline (``train/stereo_data.py``). Writes step checkpoints under
``<model_dir>/checkpoints`` and a final ``monodepth.msgpack`` that the
pipeline CLIs of both packages read.

Runs on the card (``--CUDA_DEVICE_NUMBER`` picks it) unless ``--device cpu``:

    python -m semantic_depth_tpu_torch.cli.monodepth_train --data_dir stereo \\
        --epochs 50 --batch_size 8
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..models import Monodepth
from ..train.monodepth_trainer import MonodepthTrainConfig, MonodepthTrainer
from ..train.stereo_data import StereoDataset
from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description="Train monodepth on stereo pairs.")
    p.add_argument("--data_dir", default=None,
                   help="directory containing left/ and right/ image folders")
    p.add_argument("--filenames_file", default=None,
                   help="monodepth-format list: '<left_rel> <right_rel>' per "
                        "line, relative to --data_path")
    p.add_argument("--data_path", default="",
                   help="root the filenames_file paths are relative to")
    p.add_argument("--no_augment", action="store_true",
                   help="disable flip-swap + photometric jitter")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--encoder", default="vgg")
    p.add_argument("--input_height", type=int, default=256)
    p.add_argument("--input_width", type=int, default=512)
    p.add_argument("--alpha_image_loss", type=float, default=0.85)
    p.add_argument("--disp_gradient_loss_weight", type=float, default=0.1)
    p.add_argument("--lr_loss_weight", type=float, default=1.0)
    p.add_argument("--model_dir", default="models/monodepth_torch")
    p.add_argument("--checkpoint_every", type=int, default=1000)
    p.add_argument("--CUDA_DEVICE_NUMBER", default="0", help="the CUDA card to run on")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="'cpu' runs the plain PyTorch path on the CPU (tests)")
    p.add_argument("--dev_tiny", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    hw = (args.input_height, args.input_width)
    try:
        dataset = StereoDataset(
            data_dir=args.data_dir,
            filenames_file=args.filenames_file,
            data_path=args.data_path,
            image_hw=hw,
            augment=not args.no_augment,
        )
    except ValueError as e:
        raise SystemExit(str(e))

    model = Monodepth(encoder=args.encoder, width_mult=0.0625 if args.dev_tiny else 1.0,
                      generator=torch.Generator().manual_seed(0))
    cfg = MonodepthTrainConfig(
        learning_rate=args.learning_rate,
        alpha_image_loss=args.alpha_image_loss,
        disp_gradient_loss_weight=args.disp_gradient_loss_weight,
        lr_loss_weight=args.lr_loss_weight,
    )
    trainer = MonodepthTrainer(cfg, model=model, device=common.cli_device(args))

    os.makedirs(args.model_dir, exist_ok=True)
    ckpt_dir = os.path.join(args.model_dir, "checkpoints")
    for epoch in range(1, args.epochs + 1):
        t0, losses = time.time(), []
        for left, right in dataset.batches(args.batch_size):
            m = trainer.train_batch(left, right)
            losses.append(m["loss"])
            if trainer.step % args.checkpoint_every == 0:
                trainer.save_checkpoint(ckpt_dir)
        print(
            f"Epoch {epoch}/{args.epochs}: loss {np.mean(losses):.4f} "
            f"({time.time() - t0:.1f}s, step {trainer.step})"
        )
    trainer.save_checkpoint(ckpt_dir)
    out = trainer.save_msgpack(os.path.join(args.model_dir, "monodepth.msgpack"))
    print(f"saved {out}")


if __name__ == "__main__":
    main()
