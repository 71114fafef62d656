"""Monodepth monocular disparity network (Godard et al., CVPR'17), vgg and
resnet50 encoders.

Port of the plain path of ``semantic_depth_tpu/models/monodepth.py``
(``use_deconv=False``, as the reference runs it). Conv layers pad
symmetrically by ``(k - 1) // 2`` before a VALID conv, which differs from
SAME at stride 2; ELU activations; disparity heads ``0.3 * sigmoid(conv)``;
nearest-neighbour x2 upsampling + 3x3 conv in the decoder.

resnet50: a 7x7/2 stem, a 3x3/2 max pool over a ZERO-padded map (the JAX
``_maxpool`` pads with zeros, and ELU outputs reach -1, so ``-inf`` padding
would change the border), then 3, 4, 6 and 3 bottleneck blocks whose last
block strides 2. Every block carries a learned 1x1 ``_sc`` projection
shortcut, as the published checkpoints do.

``input_s2d=True`` is the native full-resolution variant: the input is 2x2
space-to-depth packed, the trunk runs on the half-resolution grid, and an
extra level-0 decoder step (``upconv0`` / ``iconv0`` / ``disp0``) restores
the original resolution, so the pyramid has five scales.

Layer names equal the flax parameter names, so ``from_flax.load_flax`` maps
every variant strictly. Init is flax's: ``lecun_normal`` kernels and zero
biases in every conv (``models/init.py``). The JAX package's ``s2d_opt`` rewrite is a TPU
lane-filling rearrangement pinned equal to this plain path, so it has no
counterpart here.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.s2d import space_to_depth
from .init import lecun_normal_

_VGG_ENC = ((32, 7), (64, 5), (128, 3), (256, 3), (512, 3), (512, 3), (512, 3))
_VGG_DEC = (512, 512, 256, 128, 64, 32, 16)  # upconv7 .. upconv1
_RES_STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))  # res2 .. res5: (width, blocks)
_RES_DEC = (512, 256, 128, 64, 32, 16)  # upconv6 .. upconv1


def _upsample_nn(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 on NCHW (pixel repeat)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class Monodepth(nn.Module):
    """``forward(images (B, H, W, 3) in [0, 1])`` returns the disparity
    pyramid finest first, each (B, H/2^i, W/2^i, 2) float32 (left, right).
    ``disp_left`` returns the consumed surface: (B, H, W). ``generator``
    seeds the init."""

    def __init__(
        self,
        encoder: str = "vgg",
        compute_dtype: torch.dtype = torch.float32,
        width_mult: float = 1.0,
        input_s2d: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if encoder not in ("vgg", "resnet50"):
            raise ValueError(f"unknown encoder: {encoder!r}")
        self.encoder = encoder
        self.input_s2d = input_s2d
        self.compute_dtype = compute_dtype

        def ch(c):
            return max(1, int(c * width_mult))

        in_ch = 12 if input_s2d else 3
        feat_ch = []  # channels of each encoder output; the last is the bottom
        if encoder == "vgg":
            for i, (c, k) in enumerate(_VGG_ENC, start=1):
                c = ch(c)
                self._conv(f"enc{i}a", in_ch, c, k)
                self._conv(f"enc{i}b", c, c, k, stride=2)
                feat_ch.append(c)
                in_ch = c
            dec = _VGG_DEC
        else:
            self._conv("enc1", in_ch, ch(64), 7, stride=2)
            in_ch = ch(64)
            feat_ch += [in_ch, in_ch]  # conv1, pool1
            for stage, (width, blocks) in enumerate(_RES_STAGES, start=2):
                for i in range(blocks):
                    name, stride = f"res{stage}_{i}", 2 if i == blocks - 1 else 1
                    self._conv(f"{name}_c1", in_ch, ch(width), 1)
                    self._conv(f"{name}_c2", ch(width), ch(width), 3, stride=stride)
                    self._conv(f"{name}_c3", ch(width), ch(4 * width), 1)
                    self._conv(f"{name}_sc", in_ch, ch(4 * width), 1, stride=stride)
                    in_ch = ch(4 * width)
                feat_ch.append(in_ch)
            dec = _RES_DEC
        skip_ch = feat_ch[:-1]
        self.n_ups = len(dec)
        for level in range(self.n_ups, 0, -1):
            c = ch(dec[self.n_ups - level])
            self._conv(f"upconv{level}", in_ch, c, 3)
            cat_ch = c
            if 0 <= level - 2 < len(skip_ch):
                cat_ch += skip_ch[level - 2]
            if level < 4:
                cat_ch += 2  # upsampled coarser disparity
            self._conv(f"iconv{level}", cat_ch, c, 3)
            if level <= 4:
                self._conv(f"disp{level}", c, 2, 3)
            in_ch = c
        if input_s2d:
            c = ch(8)
            self._conv("upconv0", in_ch, c, 3)
            self._conv("iconv0", c + 2, c, 3)
            self._conv("disp0", c, 2, 3)
        for layer in self.children():
            lecun_normal_(layer, generator)
        self.to(compute_dtype)

    def _conv(self, name: str, cin: int, cout: int, k: int, stride: int = 1) -> None:
        self.add_module(name, nn.Conv2d(cin, cout, k, stride, (k - 1) // 2))

    def _elu(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.elu(getattr(self, name)(x))

    def _disp(self, level: int, x: torch.Tensor) -> torch.Tensor:
        return (0.3 * torch.sigmoid(getattr(self, f"disp{level}")(x))).float()

    def _encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The encoder outputs, finest first; the last one is the bottom."""
        feats = []
        if self.encoder == "vgg":
            for i in range(1, len(_VGG_ENC) + 1):
                x = self._elu(f"enc{i}b", self._elu(f"enc{i}a", x))
                feats.append(x)  # conv_i at H/2^i
            return feats
        conv1 = self._elu("enc1", x)  # H/2
        x = F.max_pool2d(F.pad(conv1, (1, 1, 1, 1)), 3, 2)  # zero padding, H/4
        feats += [conv1, x]
        for stage, (_, blocks) in enumerate(_RES_STAGES, start=2):
            for i in range(blocks):
                name = f"res{stage}_{i}"
                out = self._elu(f"{name}_c2", self._elu(f"{name}_c1", x))
                x = F.elu(getattr(self, f"{name}_c3")(out) + getattr(self, f"{name}_sc")(x))
            feats.append(x)  # res2 .. res5 at H/8 .. H/64
        return feats

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = images.to(self.compute_dtype)
        if self.input_s2d:
            x = space_to_depth(x)  # (B, H/2, W/2, 12)
        feats = self._encode(x.permute(0, 3, 1, 2))
        skips, x = feats[:-1], feats[-1]
        disps: List[torch.Tensor] = []
        udisp = None
        for level in range(self.n_ups, 0, -1):  # level = output stride exponent
            x = self._elu(f"upconv{level}", _upsample_nn(x))
            cat = [x]
            skip_idx = level - 2  # the skip feeding level L is at H/2^(L-1)
            if 0 <= skip_idx < len(skips):
                cat.append(skips[skip_idx])
            if udisp is not None:
                cat.append(udisp.to(x.dtype))
            x = self._elu(f"iconv{level}", torch.cat(cat, dim=1))
            if level <= 4:
                disp = self._disp(level, x)
                disps.append(disp)
                if level > 1:
                    udisp = _upsample_nn(disp)
        if self.input_s2d:
            # level 0: from the packed grid back to the original resolution
            x = self._elu("upconv0", _upsample_nn(x))
            x = self._elu("iconv0", torch.cat([x, _upsample_nn(disps[-1]).to(x.dtype)], dim=1))
            disps.append(self._disp(0, x))
        disps.reverse()  # finest first
        return [d.permute(0, 2, 3, 1) for d in disps]

    def disp_left(self, images: torch.Tensor) -> torch.Tensor:
        """``disp_left_est[0]``: the finest left disparity (B, H, W)."""
        return self(images)[0][..., 0]


def flip_average_postprocess(disp: torch.Tensor) -> torch.Tensor:
    """Flip-averaged disparity post-processing (semantic_depth.py:656-664).

    disp: (..., 2, H, W), row 0 from the frame and row 1 from its horizontal
    flip. Returns (..., H, W) blended with the reference's border ramps."""
    h, w = disp.shape[-2:]
    l_disp = disp[..., 0, :, :]
    r_disp = disp[..., 1, :, :].flip(-1)
    m_disp = 0.5 * (l_disp + r_disp)
    # jnp.linspace(0, 1, w) in float32 is exactly i / (w - 1)
    ramp = torch.arange(w, dtype=torch.float32, device=disp.device)
    ramp = ramp / ramp.new_tensor(float(w - 1))  # a true division on the card too
    l_mask = (1.0 - torch.clamp(20.0 * (ramp - 0.05), 0.0, 1.0)).expand(h, w)
    r_mask = l_mask.flip(-1)
    return r_mask * l_disp + l_mask * r_disp + (1.0 - l_mask - r_mask) * m_disp
