"""Cityscapes-layout dataset with the reference's augmentations (port of
``semantic_depth_tpu/train/data.py``, a copy: the port imports nothing of
the JAX package).

* file discovery pairs ``*_gtFine_labelIds.png`` ground truth with images per
  city directory (helper.py:119-133);
* label encoding: road = id 7; fence = ids {11..16} for Cityscapes-train,
  id 13 for Cityscapes-test and Roborace; background = rest; one-hot 3-class
  (helper.py:149-177);
* train-time augmentation: random crop >= 768 px wide keeping 2:1 aspect,
  contrast 0.85..1.15, brightness -40..+30 (helper.py:101-116, 229-239).

Host-side numpy, drawn from ``random.Random(seed)`` in the JAX loader's
order, so a seed gives the same batches, bit for bit, in both packages.
"""

from __future__ import annotations

import os
import queue
import random
import threading
from glob import glob
from typing import Iterator, List, Tuple

import numpy as np

from ..ops.resize import resize_clip_u8_np


def _prefetched(it: Iterator, depth: int) -> Iterator:
    """Run ``it`` in a daemon thread, keeping up to ``depth`` items ready;
    producer exceptions are re-raised at the consumer. If the consumer stops
    early (an exception mid-epoch, a ``break``), the producer is released —
    a plain blocking ``q.put`` would otherwise leave the thread stuck
    forever, pinning ~depth decoded batches per abandoned epoch."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def producer():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(done)
        except BaseException as e:
            if not stop.is_set():
                q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # drain so a producer blocked on a full queue can observe the event
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)


def get_files_paths(gt_dir: str, imgs_dir: str) -> Tuple[List[str], List[str]]:
    """Per-city discovery, sorted (helper.py:119-133)."""
    cities = os.listdir(imgs_dir)
    gt, imgs = [], []
    for city in cities:
        gt += glob(os.path.join(gt_dir, city, "*_gtFine_labelIds.png"))
        imgs += glob(os.path.join(imgs_dir, city, "*.png"))
    gt.sort()
    imgs.sort()
    return gt, imgs


def gt_path_for_image(gt_dir: str, image_file: str) -> str:
    """Map an image path to its labelIds ground truth (helper.py:212-214)."""
    city = os.path.basename(image_file).partition("_")[0]
    return os.path.join(
        gt_dir, city, os.path.basename(image_file)[:-15] + "gtFine_labelIds.png"
    )


def prepare_ground_truth(
    dataset: str, img: np.ndarray, num_classes: int = 3, mode: str = "train"
) -> np.ndarray:
    """Label-id image -> one-hot (H, W, 3): road / fence / background
    (helper.py:149-177)."""
    road_mask = img == 7
    if dataset[:4] == "city" and mode == "train":
        # Cityscapes train: ids {11..16} all count as fence (helper.py:160)
        fence_mask = np.logical_or.reduce(
            (img == 11, img == 12, img == 13, img == 14, img == 15, img == 16)
        )
    else:
        # Cityscapes val/test AND roborace (any mode): id 13 only
        # (helper.py:168-171 — roborace has no separate branch upstream)
        fence_mask = img == 13
    else_mask = ~(road_mask | fence_mask)
    out = np.zeros((img.shape[0], img.shape[1], num_classes), np.float32)
    out[:, :, 0] = road_mask
    out[:, :, 1] = fence_mask
    out[:, :, 2] = else_mask
    return out


def random_crop(img: np.ndarray, gt: np.ndarray, rng: random.Random):
    """Random >=768-px-wide crop at 2:1 aspect (helper.py:101-107). Falls back
    to the full frame when the image is narrower than 770 px (the mockup
    fixtures are small)."""
    h, w = img.shape[:2]
    if w <= 770 or h < 386:
        return img, gt
    nw = rng.randint(768, w - 2)
    nh = int(nw / 2)
    if nh > h:
        nh = h
        nw = 2 * nh
    x1 = rng.randint(0, w - nw)
    y1 = rng.randint(0, h - nh)
    return img[y1 : y1 + nh, x1 : x1 + nw], gt[y1 : y1 + nh, x1 : x1 + nw]


def bc_img(img: np.ndarray, s: float, m: float) -> np.ndarray:
    """Contrast/brightness jitter with saturation (helper.py:110-116)."""
    out = img.astype(np.int64) * s + m
    return np.clip(out, 0, 255).astype(np.uint8)


def _imread(path: str) -> np.ndarray:
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        if img.ndim == 3:
            img = img[:, :, ::-1]  # BGR -> RGB (training used RGB readers)
        return img
    except ImportError:  # pragma: no cover
        from PIL import Image

        return np.asarray(Image.open(path))


def _resize_np(img: np.ndarray, shape_hw) -> np.ndarray:
    """Host resize with the same interpolation matrices as the device resize
    (bilinear, scipy.misc.imresize's default, helper.py:232-233)."""
    return resize_clip_u8_np(img, shape_hw, "linear").astype(np.uint8)


class SegmentationDataset:
    """Batch iterator factory over a Cityscapes-layout tree
    (gen_batch_function equivalent, helper.py:180-314)."""

    def __init__(
        self,
        data_dir: str,
        dataset: str,
        image_shape=(256, 512),
        train_gt_subdir: str = "gtFine/train",
        train_imgs_subdir: str = "leftImg8bit/train",
        val_gt_subdir: str = "gtFine/val",
        val_imgs_subdir: str = "leftImg8bit/val",
        test_gt_subdir: str = "gtFine/test",
        test_imgs_subdir: str = "leftImg8bit/test",
        seed: int = 0,
    ):
        root = os.path.join(data_dir, dataset)
        self.dataset = dataset
        self.image_shape = tuple(image_shape)
        self.dirs = {
            "train": (os.path.join(root, train_gt_subdir), os.path.join(root, train_imgs_subdir)),
            "val": (os.path.join(root, val_gt_subdir), os.path.join(root, val_imgs_subdir)),
            "test": (os.path.join(root, test_gt_subdir), os.path.join(root, test_imgs_subdir)),
        }
        self.rng = random.Random(seed)

    def num_images(self, mode: str) -> int:
        _, imgs = get_files_paths(*self.dirs[mode])
        return len(imgs)

    def batches(
        self, batch_size: int = 1, mode: str = "train", prefetch: int = 2
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One epoch of (images, one-hot gt) batches. With prefetch > 0 a
        daemon thread prepares the next batches (decode + crop + jitter)
        while the card consumes the current one."""
        if prefetch > 0:
            yield from _prefetched(self._epoch(batch_size, mode), prefetch)
        else:
            yield from self._epoch(batch_size, mode)

    def _epoch(
        self, batch_size: int, mode: str
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        gt_dir, imgs_dir = self.dirs[mode]
        _, imgs_paths = get_files_paths(gt_dir, imgs_dir)
        if mode in ("train", "val"):
            self.rng.shuffle(imgs_paths)
        augment = mode == "train"
        gt_mode = "test" if mode == "test" else "train"
        for i in range(0, len(imgs_paths), batch_size):
            images, gts = [], []
            for image_file in imgs_paths[i : i + batch_size]:
                image = _imread(image_file)
                gt_image = _imread(gt_path_for_image(gt_dir, image_file))
                if augment:
                    image, gt_image = random_crop(image, gt_image, self.rng)
                image = _resize_np(image, self.image_shape)
                gt_image = np.asarray(
                    _resize_np(gt_image[:, :, None] if gt_image.ndim == 2 else gt_image,
                               self.image_shape)
                ).squeeze()
                if augment:
                    contr = self.rng.uniform(0.85, 1.15)
                    bright = self.rng.randint(-40, 30)
                    image = bc_img(image, contr, bright)
                gts.append(prepare_ground_truth(self.dataset, gt_image, mode=gt_mode))
                images.append(image)
            yield np.stack(images).astype(np.float32), np.stack(gts)
