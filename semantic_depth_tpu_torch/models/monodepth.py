"""Monodepth monocular disparity network, vgg encoder (Godard et al., CVPR'17).

Port of the plain path of ``semantic_depth_tpu/models/monodepth.py``
(``use_deconv=False``, as the reference runs it). Conv layers pad
symmetrically by ``(k - 1) // 2`` before a VALID conv, which differs from
SAME at stride 2; ELU activations; disparity heads ``0.3 * sigmoid(conv)``;
nearest-neighbour x2 upsampling + 3x3 conv in the decoder.

The JAX package's ``s2d_opt`` rewrite is a TPU lane-filling rearrangement
pinned equal to this plain path, so it has no counterpart here. The
resnet50 encoder and the native ``input_s2d`` variant are not ported yet.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

_VGG_ENC = ((32, 7), (64, 5), (128, 3), (256, 3), (512, 3), (512, 3), (512, 3))
_VGG_DEC = (512, 512, 256, 128, 64, 32, 16)  # upconv7 .. upconv1


def _upsample_nn(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 on NCHW (pixel repeat)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class Monodepth(nn.Module):
    """``forward(images (B, H, W, 3) in [0, 1])`` returns the disparity
    pyramid finest first, each (B, H/2^i, W/2^i, 2) float32 (left, right).
    ``disp_left`` returns the consumed surface: (B, H, W)."""

    def __init__(
        self,
        encoder: str = "vgg",
        compute_dtype: torch.dtype = torch.float32,
        width_mult: float = 1.0,
        input_s2d: bool = False,
    ):
        super().__init__()
        if encoder != "vgg":
            raise NotImplementedError(f"Monodepth encoder {encoder!r} is not ported yet")
        if input_s2d:
            raise NotImplementedError("Monodepth(input_s2d=True) is not ported yet")
        self.compute_dtype = compute_dtype

        def ch(c):
            return max(1, int(c * width_mult))

        in_ch = 3
        enc_ch = []
        for i, (c, k) in enumerate(_VGG_ENC, start=1):
            c = ch(c)
            self.add_module(f"enc{i}a", nn.Conv2d(in_ch, c, k, 1, (k - 1) // 2))
            self.add_module(f"enc{i}b", nn.Conv2d(c, c, k, 2, (k - 1) // 2))
            enc_ch.append(c)
            in_ch = c
        self.n_ups = len(_VGG_DEC)
        skip_ch = enc_ch[:-1]  # conv1 .. conv6
        for level in range(self.n_ups, 0, -1):
            c = ch(_VGG_DEC[self.n_ups - level])
            self.add_module(f"upconv{level}", nn.Conv2d(in_ch, c, 3, 1, 1))
            cat_ch = c
            if 0 <= level - 2 < len(skip_ch):
                cat_ch += skip_ch[level - 2]
            if level < 4:
                cat_ch += 2  # upsampled coarser disparity
            self.add_module(f"iconv{level}", nn.Conv2d(cat_ch, c, 3, 1, 1))
            if level <= 4:
                self.add_module(f"disp{level}", nn.Conv2d(c, 2, 3, 1, 1))
            in_ch = c
        self.to(compute_dtype)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = images.to(self.compute_dtype).permute(0, 3, 1, 2)
        skips = []
        for i in range(1, len(_VGG_ENC) + 1):
            x = F.elu(getattr(self, f"enc{i}a")(x))
            x = F.elu(getattr(self, f"enc{i}b")(x))
            skips.append(x)  # conv_i at H/2^i
        disps: List[torch.Tensor] = []
        udisp = None
        for level in range(self.n_ups, 0, -1):  # level = output stride exponent
            x = F.elu(getattr(self, f"upconv{level}")(_upsample_nn(x)))
            cat = [x]
            skip_idx = level - 2  # the skip feeding level L is at H/2^(L-1)
            if 0 <= skip_idx < len(skips) - 1:
                cat.append(skips[skip_idx])
            if udisp is not None:
                cat.append(udisp.to(x.dtype))
            x = F.elu(getattr(self, f"iconv{level}")(torch.cat(cat, dim=1)))
            if level <= 4:
                d = 0.3 * torch.sigmoid(getattr(self, f"disp{level}")(x))
                disp = d.float()
                disps.append(disp)
                if level > 1:
                    udisp = _upsample_nn(disp)
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
