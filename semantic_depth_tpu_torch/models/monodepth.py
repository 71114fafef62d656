"""Monodepth monocular disparity network (Godard et al., CVPR'17), vgg and
resnet50 encoders.

Port of the plain path of ``semantic_depth_tpu/models/monodepth.py``. Conv
layers pad symmetrically by ``(k - 1) // 2`` before a VALID conv, which
differs from SAME at stride 2; ELU activations; disparity heads
``0.3 * sigmoid(conv)``; nearest-neighbour x2 upsampling + 3x3 conv in the
decoder (``use_deconv=False``, as the reference runs it).

``use_deconv=True`` is the published transposed-conv decoder: each upconv
pads its input by 1, runs a 3x3 stride-2 transposed conv with SAME padding
(TF's gradient-of-conv) and crops ``[3:-1]``, a net 2x upsample. That is
torch's ``ConvTranspose2d(3, stride=2, padding=1, output_padding=1)`` on
the unpadded input, then ELU.

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
from ..runtime import annotate, device_constant
from . import spatial
from .init import lecun_normal_

_VGG_ENC = ((32, 7), (64, 5), (128, 3), (256, 3), (512, 3), (512, 3), (512, 3))
_VGG_DEC = (512, 512, 256, 128, 64, 32, 16)  # upconv7 .. upconv1
_RES_STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))  # res2 .. res5: (width, blocks)
_RES_DEC = (512, 256, 128, 64, 32, 16)  # upconv6 .. upconv1


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
        use_deconv: bool = False,
    ):
        super().__init__()
        if encoder not in ("vgg", "resnet50"):
            raise ValueError(f"unknown encoder: {encoder!r}")
        self.encoder = encoder
        self.input_s2d = input_s2d
        self.use_deconv = use_deconv
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
            self._up(f"upconv{level}", in_ch, c)
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
            self._up("upconv0", in_ch, c)
            self._conv("iconv0", c + 2, c, 3)
            self._conv("disp0", c, 2, 3)
        for layer in self.children():
            lecun_normal_(layer, generator)
        self.to(compute_dtype)

    def _conv(self, name: str, cin: int, cout: int, k: int, stride: int = 1) -> None:
        self.add_module(name, nn.Conv2d(cin, cout, k, stride, (k - 1) // 2))

    def _up(self, name: str, cin: int, cout: int) -> None:
        if self.use_deconv:
            self.add_module(name, nn.ConvTranspose2d(cin, cout, 3, 2, 1, output_padding=1))
        else:
            self._conv(name, cin, cout, 3)

    def _upconv(self, name: str, x: torch.Tensor, rows) -> torch.Tensor:
        if not self.use_deconv:
            return self._elu(name, spatial.upsample_nn(x, rows), rows)
        if rows is not None:
            raise ValueError("the transposed-conv decoder has no row-sharded form")
        return F.elu(getattr(self, name)(x))

    def _conv_at(self, name: str, x: torch.Tensor, rows) -> torch.Tensor:
        return spatial.conv(getattr(self, name), x, rows)

    def _elu(self, name: str, x: torch.Tensor, rows=None) -> torch.Tensor:
        return F.elu(self._conv_at(name, x, rows))

    def _disp(self, level: int, x: torch.Tensor, rows=None) -> torch.Tensor:
        return (0.3 * torch.sigmoid(self._conv_at(f"disp{level}", x, rows))).float()

    def _encode(self, x: torch.Tensor, rows=None) -> List[torch.Tensor]:
        """The encoder outputs, finest first; the last one is the bottom."""
        feats = []
        if self.encoder == "vgg":
            for i in range(1, len(_VGG_ENC) + 1):
                x = self._elu(f"enc{i}b", self._elu(f"enc{i}a", x, rows), rows)
                feats.append(x)  # conv_i at H/2^i
            return feats
        conv1 = self._elu("enc1", x, rows)  # H/2
        x = spatial.max_pool3_zero_padded(conv1, rows)  # H/4
        feats += [conv1, x]
        for stage, (_, blocks) in enumerate(_RES_STAGES, start=2):
            for i in range(blocks):
                name = f"res{stage}_{i}"
                out = self._elu(f"{name}_c2", self._elu(f"{name}_c1", x, rows), rows)
                x = F.elu(self._conv_at(f"{name}_c3", out, rows)
                          + self._conv_at(f"{name}_sc", x, rows))
            feats.append(x)  # res2 .. res5 at H/8 .. H/64
        return feats

    def forward(self, images: torch.Tensor, rows=None) -> List[torch.Tensor]:
        """``rows``: a ``parallel.spatial.RowShard`` when ``images`` holds
        this rank's rows of the frames (the sp mesh axis); the finest
        disparity comes back in the same rows."""
        x = images.to(self.compute_dtype)
        if self.input_s2d:
            x = space_to_depth(x)  # (B, H/2, W/2, 12)
        on_card = x.is_cuda
        with annotate("sd.mono.encoder", on_card):
            feats = self._encode(x.permute(0, 3, 1, 2), rows)
        skips, x = feats[:-1], feats[-1]
        disps: List[torch.Tensor] = []
        udisp = None
        with annotate("sd.mono.decoder", on_card):
            for level in range(self.n_ups, 0, -1):  # level = output stride exponent
                x = self._upconv(f"upconv{level}", x, rows)
                cat = [x]
                skip_idx = level - 2  # the skip feeding level L is at H/2^(L-1)
                if 0 <= skip_idx < len(skips):
                    cat.append(skips[skip_idx])
                if udisp is not None:
                    cat.append(udisp.to(x.dtype))
                x = self._elu(f"iconv{level}", torch.cat(cat, dim=1), rows)
                if level <= 4:
                    disp = self._disp(level, x, rows)
                    disps.append(disp)
                    if level > 1:
                        udisp = spatial.upsample_nn(disp, rows)
            if self.input_s2d:
                # level 0: from the packed grid back to the original resolution
                x = self._upconv("upconv0", x, rows)
                up = spatial.upsample_nn(disps[-1], rows).to(x.dtype)
                x = self._elu("iconv0", torch.cat([x, up], dim=1), rows)
                disps.append(self._disp(0, x, rows))
        disps.reverse()  # finest first
        return [d.permute(0, 2, 3, 1) for d in disps]

    def disp_left(self, images: torch.Tensor, rows=None) -> torch.Tensor:
        """``disp_left_est[0]``: the finest left disparity (B, H, W)."""
        return self(images, rows)[0][..., 0]


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
    # a true division on the card too, with no copy from the host
    ramp = ramp / device_constant(float(w - 1), disp.device)
    l_mask = (1.0 - torch.clamp(20.0 * (ramp - 0.05), 0.0, 1.0)).expand(h, w)
    r_mask = l_mask.flip(-1)
    return r_mask * l_disp + l_mask * r_disp + (1.0 - l_mask - r_mask) * m_disp
