"""DPT-Large as monodepth's network in plain PyTorch, from Ranftl,
Bochkovskiy and Koltun, "Vision Transformers for Dense Prediction", ICCV
2021, and the published code (isl-org/DPT: ``dpt/vit.py``
``_make_pretrained_vitl16_384``, ``forward_vit``, ``forward_flex``,
``_resize_pos_embed``, ``ProjectReadout``; ``dpt/blocks.py``
``_make_scratch``, ``FeatureFusionBlock_custom``,
``ResidualConvUnit_custom``; ``dpt/models.py`` ``DPT``, ``DPTDepthModel``;
the public configuration ``Intel/dpt-large``).

On images x in [0, 1] (B, H, W, 3), H and W multiples of 32:

1. ``NormalizeImage``: (x - 0.5) / 0.5. The ViT-L/16: a 16x16/16
   convolution to ``width`` (1024) channels, the class token in front, the
   position table (1, 1 + 24 * 24, width) added, its 24 x 24 grid part
   resized bilinearly (``F.interpolate``'s default, ``align_corners=False``)
   to the (H/16, W/16) patch grid and its class entry kept.
2. ``layers`` (24) pre-norm blocks (timm's ``Block``): x + proj(attn(LN1(x))),
   then x + fc2(GELU(fc1(LN2(x)))); qkv a Linear to 3 * width with bias,
   ``heads`` (16) heads of width / heads, softmax(Q K^T / sqrt(d)) V with no
   mask, fc1 to ``mlp`` (4096), the exact GELU.
3. The outputs of the blocks ``hooks`` (5, 11, 17, 23), taken by forward
   hooks before any final norm; each read out by its own "project"
   readout: concat(tokens[1:], the class token) -> Linear(2 width, width)
   -> GELU, laid onto the patch grid.
4. Reassembly (``act_postprocess1-4``) to ``neck`` (256, 512, 1024, 1024):
   a 1x1 convolution, then a 4x4/4 transposed convolution, a 2x2/2 one,
   nothing, or a 3x3/2 convolution (padding 1); all with bias. Then
   ``layer{1-4}_rn``: a bias-less 3x3 convolution to ``features`` (256).
5. ``refinenet4`` .. ``refinenet1``: out = unit2(path + unit1(skip)) with
   u(x) = x + conv2(ReLU(conv1(ReLU(x)))) (3x3 with bias); ``refinenet4``
   has no skip and runs unit2 alone; then a bilinear x2 upsample
   (``align_corners=True``) and a 1x1 convolution.
6. The head: a 3x3 convolution to features / 2, a bilinear x2 upsample
   (``align_corners=True``), a 3x3 convolution to ``head_hidden`` (32),
   ReLU, a 1x1 convolution to 1, ReLU: the inverse depth.

The disparity is ``scale * inv + shift``: ``DPTDepthModel``'s ``invert``
path takes depth as its reciprocal.

Departures from the published model:

* seeded weights by the benchmark's laws (``params``; ``harness/
  weights.make_params``), not the trained checkpoint: lecun weights, zero
  biases, LayerNorm gains one, the class token and the position table
  normal with std 0.02; but the head's last 1x1 convolution sums its
  ``head_hidden`` non-negative features (weights one). With lecun weights
  its pre-ReLU output has a mean over the frame that varies with the seed
  as a normal of std about 3.5, and a spread over the frame of 1.2-3.1
  (12 seeds measured on the card), so the last ReLU zeroed 79%, 44% and
  99.9998% of three seeds' frames: a seed could leave no network output;
* ``scale`` and ``shift`` are the configuration's, set so that the seeded
  network carries a disparity like the other cells' (the published KITTI
  pair, 6.016e-5 and 5.79e-3, would leave seeded outputs nearly constant);
* LayerNorm eps ``eps`` (1e-6, timm's ViT; ``Intel/dpt-large``'s
  configuration says 1e-12);
* ``refinenet4``'s first residual unit, built and never called by the
  published code, is not listed.

Every convolution and matrix product goes through ``nets._Net`` (attention
as two ``matmul``s and a float32 softmax), so the control's float8
operands reach all of them; LayerNorm, GELU, softmax and the resizes run
in float32. It imports nothing of the program or of JAX.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from .nets import Param, _Net
from .precision import FLOAT32, Precision

_RESAMPLE = ("t4", "t2", None, "s2")  # each hook's reassembly after its 1x1 convolution


def _linear(name, cout, cin) -> List[Param]:
    return [Param(f"{name}.weight", (cout, cin), "lecun", fan_in=cin),
            Param(f"{name}.bias", (cout,), "zeros")]


def _conv(name, cout, cin, k, bias=True) -> List[Param]:
    out = [Param(f"{name}.weight", (cout, cin, k, k), "lecun", fan_in=cin * k * k)]
    return out + ([Param(f"{name}.bias", (cout,), "zeros")] if bias else [])


def _conv_t(name, c, k) -> List[Param]:
    """A k x k / k transposed convolution, c to c channels, weight (in, out,
    k, k): each output sums ``c`` products, its fan-in."""
    return [Param(f"{name}.weight", (c, c, k, k), "lecun", fan_in=c),
            Param(f"{name}.bias", (c,), "zeros")]


def _norm(name, d) -> List[Param]:
    return [Param(f"{name}.weight", (d,), "ones"), Param(f"{name}.bias", (d,), "zeros")]


def params(net: Dict) -> List[Param]:
    """Every parameter, named as the port's ``DPT`` names it."""
    d, p, g, f = net["width"], net["patch"], net["pos_grid"], net["features"]
    out = _conv("patch_embed", d, 3, p)
    out += [Param("cls_token", (1, 1, d), "normal", std=0.02),
            Param("pos_embed", (1, 1 + g * g, d), "normal", std=0.02)]
    for i in range(net["layers"]):
        b = f"blocks.{i}"
        out += (_norm(f"{b}.norm1", d) + _linear(f"{b}.attn.qkv", 3 * d, d)
                + _linear(f"{b}.attn.proj", d, d) + _norm(f"{b}.norm2", d)
                + _linear(f"{b}.mlp.fc1", net["mlp"], d) + _linear(f"{b}.mlp.fc2", d, net["mlp"]))
    for j in range(len(net["hooks"])):
        out += _linear(f"readout.{j}", d, 2 * d)
    for j, (c, how) in enumerate(zip(net["neck"], _RESAMPLE)):
        out += _conv(f"reassemble.{j}.proj", c, d, 1)
        if how in ("t4", "t2"):
            out += _conv_t(f"reassemble.{j}.resample", c, int(how[1]))
        elif how == "s2":
            out += _conv(f"reassemble.{j}.resample", c, c, 3)
    for j, c in enumerate(net["neck"]):
        out += _conv(f"layer_rn.{j}", f, c, 3, bias=False)
    for j in range(len(net["neck"])):
        units = ("unit2",) if j == len(net["neck"]) - 1 else ("unit1", "unit2")
        for u in units:
            out += _conv(f"fusion.{j}.{u}.conv1", f, f, 3) + _conv(f"fusion.{j}.{u}.conv2", f, f, 3)
        out += _conv(f"fusion.{j}.out_conv", f, f, 1)
    h = net["head_hidden"]
    return (out + _conv("head.conv1", f // 2, f, 3) + _conv("head.conv2", h, f // 2, 3)
            + [Param("head.conv3.weight", (1, h, 1, 1), "ones"),
               Param("head.conv3.bias", (1,), "zeros")])


def _layer_norm(w, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"].float(), w[f"{name}.bias"].float(),
                        eps)


def _pos_embed(pos: torch.Tensor, grid: int, gh: int, gw: int) -> torch.Tensor:
    """``_resize_pos_embed``: the class entry, then the grid resized."""
    table = pos[0, 1:].reshape(1, grid, grid, -1).permute(0, 3, 1, 2)
    table = F.interpolate(table, size=(gh, gw), mode="bilinear", align_corners=False)
    return torch.cat([pos[:, :1], table.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], 1)


def _block(n: _Net, w, name, x, heads, eps):
    b, t, d = x.shape
    y = _layer_norm(w, f"{name}.norm1", x, eps)
    qkv = n.linear(f"{name}.attn.qkv", y).reshape(b, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    att = torch.softmax(n.matmul(q, k.transpose(-2, -1)) * (d // heads) ** -0.5, dim=-1)
    x = x + n.linear(f"{name}.attn.proj", n.matmul(att, v).transpose(1, 2).reshape(b, t, d))
    y = _layer_norm(w, f"{name}.norm2", x, eps)
    return x + n.linear(f"{name}.mlp.fc2", F.gelu(n.linear(f"{name}.mlp.fc1", y)))


def _unit(n: _Net, name, x):
    return x + n.conv(f"{name}.conv2", F.relu(n.conv(f"{name}.conv1", F.relu(x))))


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


def disparity(weights, images01: torch.Tensor, net: Dict,
              prec: Precision = FLOAT32) -> torch.Tensor:
    """images (B, H, W, 3) in [0, 1] -> ``scale * inv + shift`` (B, H, W)
    float32; ``net`` is the configuration's ``networks.monodepth``."""
    n, w = _Net(weights, prec), weights
    p, d = net["patch"], net["width"]
    x = ((images01.float() - 0.5) / 0.5).permute(0, 3, 1, 2)
    b, _, h, wd = x.shape
    gh, gw = h // p, wd // p
    tokens = n.conv("patch_embed", x, stride=p, pad=0).flatten(2).transpose(1, 2)
    x = torch.cat([w["cls_token"].float().expand(b, -1, -1), tokens], 1)
    x = x + _pos_embed(w["pos_embed"].float(), net["pos_grid"], gh, gw)
    hooked = {}
    for i in range(net["layers"]):
        x = _block(n, w, f"blocks.{i}", x, net["heads"], net["eps"])
        if i in net["hooks"]:
            hooked[i] = x
    rn = []
    for j, (i, how) in enumerate(zip(net["hooks"], _RESAMPLE)):
        t = hooked[i]
        readout = torch.cat([t[:, 1:], t[:, :1].expand(-1, t.shape[1] - 1, -1)], -1)
        y = F.gelu(n.linear(f"readout.{j}", readout)).transpose(1, 2).reshape(b, d, gh, gw)
        y = n.conv(f"reassemble.{j}.proj", y)
        if how == "t4":
            y = n.conv_t(f"reassemble.{j}.resample", y, 4, 0)
        elif how == "t2":
            y = n.conv_t(f"reassemble.{j}.resample", y, 2, 0)
        elif how == "s2":
            y = n.conv(f"reassemble.{j}.resample", y, stride=2, pad=1)
        rn.append(n.conv(f"layer_rn.{j}", y))
    last = len(rn) - 1
    path = n.conv(f"fusion.{last}.out_conv", _up2(_unit(n, f"fusion.{last}.unit2", rn[last])))
    for j in range(last - 1, -1, -1):
        y = _unit(n, f"fusion.{j}.unit2", path + _unit(n, f"fusion.{j}.unit1", rn[j]))
        path = n.conv(f"fusion.{j}.out_conv", _up2(y))
    y = _up2(n.conv("head.conv1", path))
    inv = F.relu(n.conv("head.conv3", F.relu(n.conv("head.conv2", y))))[:, 0]
    return net["scale"] * inv + net["shift"]
