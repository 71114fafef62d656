"""A toy transformer depth network for the tests of the ``params`` path.

A bias-less patch embedding (a p x p / p convolution), a class token and a
position table, one pre-norm attention block (LayerNorm, qkv, softmax
attention, projection) with its GELU MLP, a final LayerNorm, and a
bias-less 3x3 head to the two disparities 0.3 * sigmoid at the patch grid,
repeated p x p to the input's size. Its sizes are the slot's ``dim``,
``heads``, ``patch`` and ``grid`` (the patch grid's rows and columns).

``reference()`` is the plain reference module (``params``, ``disparity``)
and ``port()`` the module holding the port class ``ToyViT``; the tests put
them into ``sys.modules`` under ``REF`` (the lookup's name) and ``PORT``
(a name inside the port's package, as a configuration's ``port`` key has
to give), so no file of either package is added for it.
"""

import types

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import nets

REF = "portbench.reference.mono_toyvit"
PORT = "semantic_depth_tpu_torch.models.toyvit"
EPS = 1e-6
SIZES = dict(dim=32, heads=2, patch=16, grid=[8, 16])  # a 128x256 input


def slot(**sizes):
    """A configuration's ``networks.monodepth`` naming the toy."""
    sizes = dict(SIZES, **sizes)
    return dict(encoder="toyvit", input_s2d=False, flip_average=True, **sizes,
                port={"class": f"{PORT}:ToyViT", "kwargs": sizes})


def _linear(name, cout, cin):
    return [nets.Param(f"{name}.weight", (cout, cin), "lecun", fan_in=cin),
            nets.Param(f"{name}.bias", (cout,), "zeros")]


def _norm(name, d):
    return [nets.Param(f"{name}.weight", (d,), "ones"), nets.Param(f"{name}.bias", (d,), "zeros")]


def params(net):
    d, p = net["dim"], net["patch"]
    tokens = net["grid"][0] * net["grid"][1] + 1
    return ([nets.Param("patch.weight", (d, 3, p, p), "lecun", fan_in=3 * p * p),
             nets.Param("cls_token", (1, 1, d), "normal", std=0.02),
             nets.Param("pos_embed", (1, tokens, d), "normal", std=0.02)]
            + _norm("norm1", d) + _linear("attn.qkv", 3 * d, d) + _linear("attn.proj", d, d)
            + _norm("norm2", d) + _linear("mlp.fc1", 4 * d, d) + _linear("mlp.fc2", d, 4 * d)
            + _norm("norm", d)
            + [nets.Param("head.weight", (2, d, 3, 3), "lecun", fan_in=9 * d)])


def disparity(weights, images01, net, prec):
    n = nets._Net(weights, prec)
    d, heads, p = net["dim"], net["heads"], net["patch"]

    def norm(name, x):
        return F.layer_norm(x, (d,), weights[f"{name}.weight"].float(),
                            weights[f"{name}.bias"].float(), EPS)

    x = n.conv("patch", images01.float().permute(0, 3, 1, 2), stride=p, pad=0)
    b, _, gh, gw = x.shape
    x = torch.cat([weights["cls_token"].float().expand(b, -1, -1), x.flatten(2).transpose(1, 2)],
                  1) + weights["pos_embed"].float()
    qkv = n.linear("attn.qkv", norm("norm1", x)).reshape(b, -1, 3, heads, d // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    att = torch.softmax(n.matmul(q, k.transpose(-1, -2)) * (d // heads) ** -0.5, -1)
    x = x + n.linear("attn.proj", n.matmul(att, v).transpose(1, 2).reshape(b, -1, d))
    x = x + n.linear("mlp.fc2", F.gelu(n.linear("mlp.fc1", norm("norm2", x))))
    x = norm("norm", x)[:, 1:].transpose(1, 2).reshape(b, d, gh, gw)
    disp = 0.3 * torch.sigmoid(n.conv("head", x))
    return disp.repeat_interleave(p, 2).repeat_interleave(p, 3)[:, 0]


class ToyViT(nn.Module):
    """The toy in the port's manner: built in ``compute_dtype``, images
    (B, H, W, 3) in [0, 1] -> ``disp_left`` (B, H, W) float32."""

    def __init__(self, compute_dtype=torch.float32, dim=32, heads=2, patch=16, grid=(8, 16)):
        super().__init__()
        self.compute_dtype, self.heads, self.p = compute_dtype, heads, patch
        self.patch = nn.Conv2d(3, dim, patch, patch, bias=False)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, grid[0] * grid[1] + 1, dim))
        self.norm1, self.norm2, self.norm = (nn.LayerNorm(dim, eps=EPS) for _ in range(3))
        self.attn = nn.Module()
        self.attn.qkv, self.attn.proj = nn.Linear(dim, 3 * dim), nn.Linear(dim, dim)
        self.mlp = nn.Module()
        self.mlp.fc1, self.mlp.fc2 = nn.Linear(dim, 4 * dim), nn.Linear(4 * dim, dim)
        self.head = nn.Conv2d(dim, 2, 3, padding=1, bias=False)
        self.to(compute_dtype)

    def disp_left(self, images, rows=None):
        if rows is not None:
            raise ValueError("the toy takes whole frames")
        x = self.patch(images.to(self.compute_dtype).permute(0, 3, 1, 2))
        b, d, gh, gw = x.shape
        x = torch.cat([self.cls_token.expand(b, -1, -1), x.flatten(2).transpose(1, 2)], 1)
        x = x + self.pos_embed
        q, k, v = self.attn.qkv(self.norm1(x)).reshape(b, -1, 3, self.heads,
                                                        d // self.heads).permute(2, 0, 3, 1, 4)
        att = torch.softmax(q @ k.transpose(-1, -2) * (d // self.heads) ** -0.5, -1)
        x = x + self.attn.proj((att @ v).transpose(1, 2).reshape(b, -1, d))
        x = x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))
        x = self.norm(x)[:, 1:].transpose(1, 2).reshape(b, d, gh, gw)
        disp = (0.3 * torch.sigmoid(self.head(x))).float()
        return disp.repeat_interleave(self.p, 2).repeat_interleave(self.p, 3)[:, 0]


def reference():
    mod = types.ModuleType(REF)
    mod.params, mod.disparity = params, disparity
    return mod


def port():
    mod = types.ModuleType(PORT)
    mod.ToyViT = ToyViT
    return mod
