"""DPT-Large as the monocular depth network (Ranftl, Bochkovskiy and Koltun,
"Vision Transformers for Dense Prediction", ICCV 2021; isl-org/DPT
``DPTDepthModel`` with the ``vitl16_384`` backbone; ``Intel/dpt-large``).

On images in [0, 1] whose sides are multiples of 32:

* ``(x - 0.5) / 0.5``; a 16x16/16 patch embedding to ``width`` channels;
  the class token in front; the position table added, its ``pos_grid`` x
  ``pos_grid`` part resized bilinearly (``align_corners=False``) to the
  patch grid inside ``forward``, its class entry kept as it is;
* ``layers`` pre-norm blocks, ``x + proj(attn(LN(x)))`` then ``x +
  fc2(GELU(fc1(LN(x))))``: ``heads`` heads, softmax(QK^T / sqrt(d)) V
  through ``F.scaled_dot_product_attention``, exact GELU, LayerNorm eps
  ``eps``;
* the outputs of the blocks ``hooks`` (no final norm), each read out by
  its own "project" readout, ``GELU(Linear(concat(tokens, class token)))``,
  onto the patch grid;
* reassembly to ``neck`` channels at 1/4, 1/8, 1/16 and 1/32 of the input
  (a 1x1 convolution, then a 4x4/4 or 2x2/2 transposed convolution,
  nothing, or a 3x3/2 convolution), and a bias-less 3x3 convolution of
  each to ``features`` channels;
* four fusion blocks, the deepest first: ``unit2(path + unit1(skip))``
  with residual units ``x + conv2(ReLU(conv1(ReLU(x))))``, a bilinear x2
  upsample (``align_corners=True``) and a 1x1 convolution. The deepest
  block has no skip, so it runs ``unit2`` alone; its ``unit1``, which the
  published code builds and never calls, is left out;
* the head: a 3x3 convolution to ``features / 2``, a bilinear x2 upsample
  (``align_corners=True``), a 3x3 convolution to ``head_hidden``, ReLU, a
  1x1 convolution to one channel, ReLU: the inverse depth ``inv``.

``DPTDepthModel``'s ``invert`` path takes depth as 1 / (``scale`` * inv +
``shift``); ``disp_left`` returns ``scale * inv + shift`` in float32, the
disparity that the pipeline multiplies by ``disparity_mult``. The network
computes in ``compute_dtype``. It has no row-sharded or ``input_s2d`` form.

Parameter names are this module's own (``blocks.{i}.attn.qkv.weight``,
``fusion.{j}.unit2.conv1.bias``, ...); the published checkpoint's would
need a loader. Init: ``lecun_normal`` weights (a transposed convolution
whose stride equals its kernel sums ``in`` products an output: that is its
fan-in), zero biases, LayerNorm gains one, the class token and the
position table normal with std 0.02; the head's last convolution sums its
non-negative features (weights one), since with random signs its output
falls below the last ReLU over whole frames for some draws.

Each attention call counts once in ``runtime.launches["sdpa"]``; a CUDA
graph's replay adds what its capture counted (``graphs.Captured``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime import annotate, launches
from .init import lecun_normal_

_RESAMPLE = (4, 2, 1, 0.5)  # each hook's scale onto the patch grid (1/16 of the input)


def _with_class_token(tokens: torch.Tensor) -> torch.Tensor:
    """(B, 1 + N, C) -> (B, N, 2C): each patch token beside the class token."""
    n = tokens.shape[1] - 1
    return torch.cat([tokens[:, 1:], tokens[:, :1].expand(-1, n, -1)], dim=-1)


def _resize_pos(pos: torch.Tensor, grid: int, gh: int, gw: int) -> torch.Tensor:
    """The (1, 1 + grid^2, C) table at a (gh, gw) patch grid: the grid part
    resized bilinearly in float32, the class entry as it is."""
    table = pos[:, 1:].reshape(1, grid, grid, -1).permute(0, 3, 1, 2).float()
    table = F.interpolate(table, size=(gh, gw), mode="bilinear", align_corners=False)
    return torch.cat([pos[:, :1], table.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
                      .to(pos.dtype)], dim=1)


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        q, k, v = self.qkv(x).view(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, k, v)
        launches["sdpa"] += 1
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class _Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class _Block(nn.Module):
    def __init__(self, width: int, heads: int, mlp: int, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=eps)
        self.attn = _Attention(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=eps)
        self.mlp = _Mlp(width, mlp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _Reassemble(nn.Module):
    def __init__(self, width: int, out: int, factor: float):
        super().__init__()
        self.proj = nn.Conv2d(width, out, 1)
        if factor > 1:
            self.resample = nn.ConvTranspose2d(out, out, int(factor), int(factor))
        elif factor < 1:
            self.resample = nn.Conv2d(out, out, 3, 2, 1)
        else:
            self.resample = nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resample(self.proj(x))


class _ResidualUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class _Fusion(nn.Module):
    def __init__(self, features: int, skip: bool):
        super().__init__()
        self.align_corners = True
        if skip:
            self.unit1 = _ResidualUnit(features)
        self.unit2 = _ResidualUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, path: torch.Tensor, skip=None) -> torch.Tensor:
        if skip is not None:
            path = path + self.unit1(skip)
        x = F.interpolate(self.unit2(path), scale_factor=2, mode="bilinear",
                          align_corners=self.align_corners)
        return self.out_conv(x)


class _Head(nn.Module):
    def __init__(self, features: int, hidden: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.conv2 = nn.Conv2d(features // 2, hidden, 3, padding=1)
        self.conv3 = nn.Conv2d(hidden, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(self.conv1(x), scale_factor=2, mode="bilinear", align_corners=True)
        return F.relu(self.conv3(F.relu(self.conv2(x))))


class DPT(nn.Module):
    """``disp_left(images (B, H, W, 3) in [0, 1])`` -> (B, H, W) float32,
    ``scale * inv + shift``. The defaults are DPT-Large's published widths
    but ``scale`` and ``shift``, which the caller gives."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32, width: int = 1024,
                 layers: int = 24, heads: int = 16, mlp: int = 4096, patch: int = 16,
                 pos_grid: int = 24, hooks: Sequence[int] = (5, 11, 17, 23),
                 neck: Sequence[int] = (256, 512, 1024, 1024), features: int = 256,
                 head_hidden: int = 32, eps: float = 1e-6, scale: float = 1.0,
                 shift: float = 0.0):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.patch, self.pos_grid, self.hooks = patch, pos_grid, tuple(hooks)
        self.scale, self.shift = float(scale), float(shift)
        self.patch_embed = nn.Conv2d(3, width, patch, patch)
        self.cls_token = nn.Parameter(torch.empty(1, 1, width))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + pos_grid * pos_grid, width))
        self.blocks = nn.ModuleList(_Block(width, heads, mlp, eps) for _ in range(layers))
        self.readout = nn.ModuleList(nn.Linear(2 * width, width) for _ in hooks)
        self.reassemble = nn.ModuleList(_Reassemble(width, c, f) for c, f in zip(neck, _RESAMPLE))
        self.layer_rn = nn.ModuleList(nn.Conv2d(c, features, 3, padding=1, bias=False)
                                      for c in neck)
        self.fusion = nn.ModuleList(_Fusion(features, skip=j < len(neck) - 1)
                                    for j in range(len(neck)))
        self.head = _Head(features, head_hidden)
        for m in self.modules():
            if isinstance(m, nn.ConvTranspose2d):
                lecun_normal_(m, fan_in=m.in_channels)
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m)
        nn.init.ones_(self.head.conv3.weight)
        nn.init.normal_(self.cls_token, std=0.02)
        nn.init.normal_(self.pos_embed, std=0.02)
        self.to(compute_dtype)

    def _encode(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The hooked blocks' outputs, (B, 1 + N, C) each."""
        b, h, w, _ = x.shape
        tokens = self.patch_embed(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        pos = _resize_pos(self.pos_embed, self.pos_grid, h // self.patch, w // self.patch)
        x = torch.cat([self.cls_token.expand(b, -1, -1), tokens], dim=1) + pos
        hooked = {}
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in self.hooks:
                hooked[i] = x
        return [hooked[i] for i in self.hooks]

    def _decode(self, hooked: List[torch.Tensor], gh: int, gw: int) -> torch.Tensor:
        """The inverse depth (B, H, W) from the hooked tokens."""
        rn = []
        for j, tokens in enumerate(hooked):
            x = F.gelu(self.readout[j](_with_class_token(tokens)))
            x = x.transpose(1, 2).reshape(x.shape[0], -1, gh, gw)
            rn.append(self.layer_rn[j](self.reassemble[j](x)))
        path = self.fusion[-1](rn[-1])
        for j in range(len(rn) - 2, -1, -1):
            path = self.fusion[j](path, rn[j])
        return self.head(path)[:, 0]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        on_card = images.is_cuda
        x = ((images.float() - 0.5) / 0.5).to(self.compute_dtype)
        with annotate("sd.mono.encoder", on_card):
            hooked = self._encode(x)
        with annotate("sd.mono.decoder", on_card):
            inv = self._decode(hooked, x.shape[1] // self.patch, x.shape[2] // self.patch)
        return inv.float() * self.scale + self.shift

    def disp_left(self, images: torch.Tensor, rows=None) -> torch.Tensor:
        """The disparity (B, H, W) of whole frames; ``rows`` (a row shard)
        is refused: attention mixes every row of the frame."""
        if rows is not None:
            raise ValueError("DPT has no row-sharded form: attention mixes every row")
        return self(images)
