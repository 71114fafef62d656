"""FCN-8s semantic segmentation (VGG16 encoder, 3-skip decoder).

Port of ``semantic_depth_tpu/models/fcn8s.py`` (plain path). Public layout
stays NHWC: ``forward(images (B, H, W, 3)) -> logits (B, H, W, C)``; the
layers run NCHW inside. Raw 0..255 intensities go in, as in the reference.

The decoder's transposed convolutions are the JAX package's
``ConvTranspose(transpose_kernel=True, padding="SAME")`` in TF kernel layout.
For kernel k and stride s, SAME pads the dilated input by
``ceil((k + s - 2) / 2)`` on each side, which is torch's ``padding = k - 1 -
that``: 1 for the 4x4/2 upsamplers and 4 for the 16x16/8 one. The kernel
needs no flip (``from_flax`` only permutes its axes).

``input_s2d=True`` is the native full-resolution variant: the input is 2x2
space-to-depth packed (12 channels into ``conv1_1``), the trunk runs on the
half-resolution grid, and ``upscore8`` emits the four pixel phases as
channel groups that ``depth_to_space`` puts back at the input resolution.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.s2d import depth_to_space, space_to_depth

# VGG16 conv stacks: (num convs, channels) per block; pools between blocks.
_VGG_BLOCKS: Sequence[tuple] = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


class FCN8s(nn.Module):
    """FCN-8s with VGG16 encoder. Parameters and compute share
    ``compute_dtype``; logits come back float32. Dropout is off at inference
    and this port holds no training path, so it has no dropout layer."""

    def __init__(
        self,
        num_classes: int = 3,
        compute_dtype: torch.dtype = torch.float32,
        width_mult: float = 1.0,
        fc_channels: int = 4096,
        input_s2d: bool = False,
    ):
        super().__init__()
        self.input_s2d = input_s2d
        self.compute_dtype = compute_dtype
        self.num_classes = num_classes
        self.convs = []
        in_ch = 12 if input_s2d else 3
        for bi, (n_convs, ch) in enumerate(_VGG_BLOCKS, start=1):
            ch = max(1, int(ch * width_mult))
            names = []
            for ci in range(1, n_convs + 1):
                name = f"conv{bi}_{ci}"
                self.add_module(name, nn.Conv2d(in_ch, ch, 3, padding=1))
                names.append(name)
                in_ch = ch
            self.convs.append(names)
        pool3_ch = max(1, int(_VGG_BLOCKS[2][1] * width_mult))
        pool4_ch = max(1, int(_VGG_BLOCKS[3][1] * width_mult))
        self.fc6 = nn.Conv2d(in_ch, fc_channels, 7, padding=3)
        self.fc7 = nn.Conv2d(fc_channels, fc_channels, 1)
        nc = num_classes
        self.score_fc7 = nn.Conv2d(fc_channels, nc, 1)
        self.score_pool4 = nn.Conv2d(pool4_ch, nc, 1)
        self.score_pool3 = nn.Conv2d(pool3_ch, nc, 1)
        self.upscore2 = nn.ConvTranspose2d(nc, nc, 4, stride=2, padding=1)
        self.upscore4 = nn.ConvTranspose2d(nc, nc, 4, stride=2, padding=1)
        self.upscore8 = nn.ConvTranspose2d(nc, 4 * nc if input_s2d else nc, 16, stride=8,
                                           padding=4)
        self.to(compute_dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.compute_dtype)
        if self.input_s2d:
            x = space_to_depth(x)  # (B, H/2, W/2, 12)
        x = x.permute(0, 3, 1, 2)
        skips = {}
        for bi, names in enumerate(self.convs, start=1):
            for name in names:
                x = F.relu(getattr(self, name)(x))
            x = F.max_pool2d(x, 2, 2)
            if bi == 3:
                skips["pool3"] = x  # H/8
            elif bi == 4:
                skips["pool4"] = x  # H/16
        x = F.relu(self.fc6(x))
        x = F.relu(self.fc7(x))  # H/32
        fuse4 = self.upscore2(self.score_fc7(x)) + self.score_pool4(skips["pool4"])
        fuse3 = self.upscore4(fuse4) + self.score_pool3(skips["pool3"])
        up8 = self.upscore8(fuse3).permute(0, 2, 3, 1)
        if self.input_s2d:
            up8 = depth_to_space(up8)
        return up8.float()
