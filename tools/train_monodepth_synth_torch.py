#!/usr/bin/env python3
"""Monodepth's training converges on synthetic stereo with known disparity,
shown with the PyTorch port (port of ``tools/train_monodepth_synth.py``).

    python3 tools/train_monodepth_synth_torch.py [--steps 2500] [--batch 4]
        [--height 256 --width 512] [--width_mult 1.0] [--lr 1e-4] [--device cpu]
    torchrun --nproc_per_node N tools/train_monodepth_synth_torch.py --mesh ...

Textured stereo pairs whose left view is the right view warped by an
analytic ground-plane disparity field (24 training pairs and one held-out
pair, from ``default_rng(0)``); the full-size network (or ``--width_mult``)
trains from its seeded init with the reference's unsupervised objective
(``train/monodepth_trainer.py``), and the held-out pair's predicted left
disparity is held against the true one below the horizon: correlation and
mean absolute error in pixels. ``--mesh`` splits each batch over the ranks
torchrun launched (``MonodepthTrainer(mesh=...)``, gradients averaged);
rank 0 alone prints. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def smooth_texture(rng, h, w, octaves=6):
    """Multi-octave smooth noise: enough gradient structure for SSIM/L1."""
    img = np.zeros((h, w, 3), np.float32)
    for o in range(octaves):
        hs, ws = max(2, h >> (octaves - o)), max(2, w >> (octaves - o))
        base = rng.uniform(0, 1, (hs, ws, 3)).astype(np.float32)
        ys = np.linspace(0, hs - 1, h)
        xs = np.linspace(0, ws - 1, w)
        yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
        yf, xf = (ys - yi)[:, None, None], (xs - xi)[None, :, None]
        yi2, xi2 = np.minimum(yi + 1, hs - 1), np.minimum(xi + 1, ws - 1)
        up = (
            base[yi][:, xi] * (1 - yf) * (1 - xf)
            + base[yi][:, xi2] * (1 - yf) * xf
            + base[yi2][:, xi] * yf * (1 - xf)
            + base[yi2][:, xi2] * yf * xf
        )
        img += up / (2 ** (octaves - o))
    img /= img.max()
    return img


def disparity_field(h, w, slope):
    """Ground-plane-like normalized disparity: 0 above the horizon, ramping
    to ``slope`` at the bottom (values inside the net's (0, 0.3) range)."""
    horizon = int(h * 0.4)
    ys = np.arange(h, dtype=np.float32)
    ramp = np.clip((ys - horizon) / (h - horizon), 0, 1) * slope + 0.01
    return np.broadcast_to(ramp[:, None], (h, w)).astype(np.float32)


def make_pair(rng, h, w, slope):
    """right = texture; left(y, x) = right(y, x - d_px(y, x)) (bilinear)."""
    right = smooth_texture(rng, h, w)
    d_norm = disparity_field(h, w, slope)
    d_px = d_norm * w
    xs = np.arange(w, dtype=np.float32)[None, :]
    src = xs - d_px  # sample position in the right image
    x0 = np.clip(np.floor(src).astype(int), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    f = (src - x0)[..., None]
    rows = np.arange(h)[:, None]
    left = right[rows, x0] * (1 - f) + right[rows, x1] * f
    return left.astype(np.float32), right, d_norm


def make_data(h, w, n_train=24):
    """The training pairs and the held-out pair, drawn as the JAX tool draws
    them; returns (pairs, held-out (left, right, d_norm), the generator the
    batch indices are then drawn from)."""
    rng = np.random.default_rng(0)
    pairs = [make_pair(rng, h, w, slope=rng.uniform(0.08, 0.2)) for _ in range(n_train)]
    held = make_pair(rng, h, w, slope=0.15)
    return pairs, held, rng


def parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=2500)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--width_mult", type=float, default=1.0,
                   help="channel width multiplier (tiny smoke runs)")
    p.add_argument("--mesh", action="store_true",
                   help="split each stereo batch over the ranks torchrun launched "
                        "(the average_gradients.py tower analog)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def run(args, log=print):
    """Train and evaluate; returns dict(losses (every step's),
    corr, mae_px, step_s (mean seconds a step), true_px (min, max))."""
    import torch

    from semantic_depth_tpu_torch.cli import common
    from semantic_depth_tpu_torch.models import Monodepth
    from semantic_depth_tpu_torch.train.monodepth_trainer import (
        MonodepthTrainConfig,
        MonodepthTrainer,
    )

    h, w = args.height, args.width
    pairs, (held_l, _, held_d), rng = make_data(h, w)
    device = "cpu" if args.device == "cpu" else None
    mesh, own_group = None, False
    if args.mesh:
        from semantic_depth_tpu_torch.parallel import make_mesh

        device, own_group = common.join_mesh(args)
        mesh = make_mesh()
    if not common.is_writer():
        log = lambda *a, **k: None  # noqa: E731 -- rank 0 alone prints
    if mesh is not None:
        log(f"mesh: {mesh.size()} ranks, {args.batch // mesh.size()} pairs a rank")
    model = Monodepth(encoder="vgg", width_mult=args.width_mult,
                      generator=torch.Generator().manual_seed(0))
    trainer = MonodepthTrainer(MonodepthTrainConfig(learning_rate=args.lr), model=model,
                               device=device, mesh=mesh)
    losses, t0 = [], time.time()
    for step in range(args.steps):
        idx = rng.integers(0, len(pairs), size=args.batch)
        left = np.stack([pairs[i][0] for i in idx])
        right = np.stack([pairs[i][1] for i in idx])
        m = trainer.train_batch(left, right)
        losses.append(m["loss"])
        if step % 25 == 0 or step == args.steps - 1:
            log(f"step {step:4d}: loss {m['loss']:.4f} (im {m['image_loss']:.4f} "
                f"lr {m['lr_loss']:.4f}) [{time.time() - t0:.0f}s]")
    step_s = (time.time() - t0) / max(args.steps, 1)

    # held-out evaluation: predicted left disparity against the truth
    with torch.no_grad():
        pred = trainer.model.disp_left(trainer._tensor(held_l[None]))[0].cpu().numpy()
    mask = held_d > 0.02  # below the horizon, where disparity is informative
    corr = float(np.corrcoef(pred[mask], held_d[mask])[0, 1])
    mae_px = float(np.abs(pred[mask] - held_d[mask]).mean() * w)
    true_px = (float(held_d[mask].min() * w), float(held_d[mask].max() * w))
    log(f"held-out: corr(pred, true)={corr:.3f}, MAE {mae_px:.2f} px "
        f"(true range {true_px[0]:.1f}..{true_px[1]:.1f} px)")
    if args.mesh:
        common.leave_mesh(own_group)
    return dict(losses=losses, corr=corr, mae_px=mae_px, step_s=step_s, true_px=true_px)


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
