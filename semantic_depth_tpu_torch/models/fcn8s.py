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

Init is flax's (``models/init.py``): encoder kernels ``lecun_normal``,
decoder kernels ``truncated_normal(0.01)``, biases zero.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.s2d import depth_to_space, space_to_depth
from .init import lecun_normal_, truncated_normal_

# VGG16 conv stacks: (num convs, channels) per block; pools between blocks.
_VGG_BLOCKS: Sequence[tuple] = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
DECODER_LAYERS = ("score_fc7", "score_pool4", "score_pool3", "upscore2", "upscore4", "upscore8")


class FCN8s(nn.Module):
    """FCN-8s with VGG16 encoder. Parameters and compute share
    ``compute_dtype``; logits come back float32. ``dropout_keep_prob`` is the
    probability of keeping a unit after the fc6 and fc7 ReLUs when
    ``forward`` runs with ``train=True`` (the reference feeds 0.5 in
    training). ``generator`` seeds the init."""

    def __init__(
        self,
        num_classes: int = 3,
        compute_dtype: torch.dtype = torch.float32,
        dropout_keep_prob: float = 0.5,
        width_mult: float = 1.0,
        fc_channels: int = 4096,
        input_s2d: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.input_s2d = input_s2d
        self.compute_dtype = compute_dtype
        self.num_classes = num_classes
        self.dropout_keep_prob = dropout_keep_prob
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
        for name, layer in self.named_children():
            if name in DECODER_LAYERS:
                truncated_normal_(layer, 0.01, generator)  # fcn.py:161
            else:
                lecun_normal_(layer, generator)
        self.to(compute_dtype)

    def _dropout(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """flax's inverted dropout at rate 1 - keep: each unit kept with
        probability keep and scaled by 1 / keep, the mask drawn from
        ``generator``. A keep of 1 returns the input unchanged, as flax does
        at rate 0. The masks cannot equal flax's, whose stream is JAX's."""
        keep = self.dropout_keep_prob
        if keep == 1.0:
            return x
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        # a true division (a host scalar would be a multiply by 1 / keep on the card)
        return torch.where(mask, x / x.new_tensor(keep), 0.0)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
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
        if train:
            x = self._dropout(x, generator)
        x = F.relu(self.fc7(x))  # H/32
        if train:
            x = self._dropout(x, generator)
        fuse4 = self.upscore2(self.score_fc7(x)) + self.score_pool4(skips["pool4"])
        fuse3 = self.upscore4(fuse4) + self.score_pool3(skips["pool3"])
        up8 = self.upscore8(fuse3).permute(0, 2, 3, 1)
        if self.input_s2d:
            up8 = depth_to_space(up8)
        return up8.float()


def decoder_l2_loss(module: FCN8s, scale: float = 1e-3) -> torch.Tensor:
    """The reference's l2_regularizer on every decoder kernel (fcn.py:169-213):
    ``0.5 * scale * sum(w^2)``, which no layout permutation changes."""
    total = 0.0
    for name in DECODER_LAYERS:
        total = total + torch.sum(torch.square(getattr(module, name).weight.float()))
    return 0.5 * scale * total
