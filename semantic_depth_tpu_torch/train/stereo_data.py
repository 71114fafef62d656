"""Stereo-pair dataset for monodepth training (port of
``semantic_depth_tpu/train/stereo_data.py``, a copy): a filename-list loader
with the published monodepth train-time augmentations.

* a *filenames file* whose lines hold ``<left_rel_path> <right_rel_path>``
  relative to a data root (KITTI/Cityscapes list format), or a directory
  with ``left/`` and ``right/``;
* per-pair random horizontal flip that also SWAPS left/right (a flipped
  right camera is a valid left view);
* with probability 0.5, a photometric jitter applied identically to both
  images: gamma in [0.8, 1.2], brightness in [0.5, 2.0], a per-channel
  color shift in [0.8, 1.2], clipped back to [0, 1];
* images resized to (h, w), float32 in [0, 1].

Every draw comes from one ``np.random.default_rng(seed)`` in the JAX
loader's order, so a seed gives the same batches, bit for bit, in both
packages. ``batches`` prepares the next batches on a background thread while
the card trains on the current one.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..ops.resize import resize_clip_u8_np
from .data import _prefetched


def read_filenames_file(path: str) -> List[Tuple[str, str]]:
    """Parse a monodepth filenames list: two whitespace-separated relative
    paths per line; blank lines ignored."""
    pairs = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 2:
                raise ValueError(f"filenames line needs 2 paths: {line!r}")
            pairs.append((parts[0], parts[1]))
    return pairs


def pairs_from_dirs(data_dir: str) -> List[Tuple[str, str]]:
    """left/<name> matched with right/<name> (the round-1 directory layout)."""
    lefts = sorted(glob(os.path.join(data_dir, "left", "*")))
    rights = sorted(glob(os.path.join(data_dir, "right", "*")))
    if not lefts or len(lefts) != len(rights):
        raise ValueError(
            f"need matched left/right images under {data_dir} "
            f"(found {len(lefts)} / {len(rights)})"
        )
    return list(zip(lefts, rights))


def photometric_jitter(
    left: np.ndarray, right: np.ndarray, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """The published monodepth augmentation: identical (gamma, brightness,
    per-channel color) jitter on both views, clipped to [0, 1]. Inputs and
    outputs are float32 in [0, 1]."""
    gamma = rng.uniform(0.8, 1.2)
    brightness = rng.uniform(0.5, 2.0)
    colors = rng.uniform(0.8, 1.2, size=3).astype(np.float32)

    def apply(img):
        out = img ** gamma
        out = out * brightness
        out = out * colors[None, None, :]
        return np.clip(out, 0.0, 1.0).astype(np.float32)

    return apply(left), apply(right)


def augment_pair(
    left: np.ndarray, right: np.ndarray, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Random flip-and-swap (p=0.5) then photometric jitter (p=0.5)."""
    if rng.uniform() > 0.5:
        left, right = right[:, ::-1].copy(), left[:, ::-1].copy()
    if rng.uniform() > 0.5:
        left, right = photometric_jitter(left, right, rng)
    return left, right


class StereoDataset:
    """Shuffled, augmented, prefetched stereo batches.

    sources: ``filenames_file`` + ``data_path`` (upstream list format) OR
    ``data_dir`` with left/ right/ subdirs. Deterministic given ``seed``.
    """

    def __init__(
        self,
        data_dir: Optional[str] = None,
        filenames_file: Optional[str] = None,
        data_path: str = "",
        image_hw: Tuple[int, int] = (256, 512),
        seed: int = 0,
        augment: bool = True,
    ):
        if filenames_file:
            rel = read_filenames_file(filenames_file)
            self.pairs = [
                (os.path.join(data_path, l), os.path.join(data_path, r))
                for l, r in rel
            ]
        elif data_dir:
            self.pairs = pairs_from_dirs(data_dir)
        else:
            raise ValueError("need data_dir or filenames_file")
        self.image_hw = tuple(image_hw)
        self.rng = np.random.default_rng(seed)
        self.augment = augment

    def __len__(self) -> int:
        return len(self.pairs)

    def _load(self, path: str) -> np.ndarray:
        from ..cli.common import imread_bgr

        img = imread_bgr(path)[:, :, ::-1].astype(np.float32)  # RGB
        # BILINEAR, not the cubic default: the published recipe resizes with
        # tf.image.resize_images (bilinear)
        return resize_clip_u8_np(img, self.image_hw, method="linear") / np.float32(255.0)

    def _epoch_batches(self, batch_size: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self.rng.permutation(len(self.pairs))
        for i in range(0, len(order), batch_size):
            lefts, rights = [], []
            for j in order[i : i + batch_size]:
                l = self._load(self.pairs[j][0])
                r = self._load(self.pairs[j][1])
                if self.augment:
                    l, r = augment_pair(l, r, self.rng)
                lefts.append(l)
                rights.append(r)
            yield np.stack(lefts), np.stack(rights)

    def batches(
        self, batch_size: int, prefetch: int = 2
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One shuffled epoch; with prefetch > 0 a daemon thread prepares the
        next ``prefetch`` batches while the accelerator consumes the current
        one (decode/jitter overlap device compute)."""
        if prefetch <= 0:
            yield from self._epoch_batches(batch_size)
            return
        yield from _prefetched(self._epoch_batches(batch_size), prefetch)
