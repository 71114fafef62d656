"""FCN-8s (VGG16) and monodepth-vgg in plain PyTorch, from their papers.

FCN-8s (Long et al., CVPR 2015): the VGG16 trunk (13 3x3 convolutions in
five blocks, a 2x2 max pool after each), fc6 as a 7x7 convolution and fc7
as a 1x1, both with ReLU, then the 8s decoder: 1x1 class scores of fc7,
pool4 and pool3, fused by 4x4/2 transposed convolutions, and a 16x16/8
transposed convolution to the input size. Raw 0..255 intensities go in.

Monodepth (Godard et al., CVPR 2017), vgg encoder: seven levels of two
convolutions (the second of stride 2; kernels 7, 5, 3, 3, 3, 3, 3), each
padded by (k - 1) // 2 on every side, ELU after every convolution; the
decoder upsamples by pixel repetition and a 3x3 convolution, concatenates
the encoder level of the same size and, below level 4, the upsampled
coarser disparity, and emits disparities 0.3 * sigmoid(conv) at levels 4
to 1. The finest left disparity is the output.

The native full-resolution variant (``input_s2d``) packs 2x2 pixels into
channels (phase-major: channel (di * 2 + dj) * C + c), runs the same trunks
on the half-resolution grid, has FCN-8s's last layer emit the four phases'
classes and puts them back, and gives monodepth a fifth decoder step
(``upconv0`` / ``iconv0`` / ``disp0``) at the input resolution.

Weights are a dict keyed as the layers below (``<layer>.weight``,
``<layer>.bias``), convolution weights (out, in, k, k), transposed ones
(in, out, k, k). ``layers`` lists each layer with its shape and init law.

A configuration names each network's encoder (``networks.fcn8s.encoder``,
``networks.monodepth.encoder``); ``network(kind, encoder)`` gives its
reference, for the kinds ``fcn`` and ``mono``. ``vgg16`` (fcn) and ``vgg``
(mono) are the networks above; any other encoder is the module
``<kind>_<encoder>.py`` beside this one (``mono_resnet50.py``), which:

* exports its parameters in one of two ways. ``layers(input_s2d, width)``
  (fcn: ``layers(input_s2d, width, num_classes, fc_channels)``) gives the
  ``Layer`` list of a network of convolutions, each with a ``.weight`` and
  a zero ``.bias``. ``params(net)``, where ``net`` is the configuration's
  ``networks.<slot>`` dict, gives the ``Param`` list of any network: each
  key of the weights with its shape and init law (``lecun``, ``normal``,
  ``zeros``, ``ones``), so Linear layers, LayerNorm gains, tokens, position
  tables and bias-less convolutions (a weight with no ``.bias`` entry) can
  be listed. Either way the names are the port's parameter names. Where a
  module exports both, ``params`` is used;
* exports the float32 forward pass, mono ``disparity(weights, images01,
  arg, prec)`` -> (B, H, W), fcn ``logits(weights, images, arg, prec)`` ->
  (B, H, W, C), where ``arg`` is ``input_s2d`` for a ``layers`` module and
  the ``networks.<slot>`` dict for a ``params`` one (``forward_arg``). An
  fcn network's last layer is ``upscore8``, whose bias carries the
  calibration's road logit bias on every pixel phase;
* runs every convolution through ``_Net.conv`` / ``conv_t`` and every
  matrix product of the network (a Linear layer, attention's two products)
  through ``_Net.linear`` / ``matmul``, so that the control's float8
  operands and ``REORDERED`` reach it as they reach vgg;
* computes in float32, and imports nothing of the program or of JAX.

A new network therefore comes in as new files and entries, and edits
none: its reference module here; a configuration under
``portbench/configs/`` whose slot names the encoder and, where the port
builds the network with another class than ``FCN8s`` / ``Monodepth``, that
class under ``"port": {"class": "semantic_depth_tpu_torch.<module>:<Class>",
"kwargs": {...}}`` (``harness/setup.py`` builds it on the meta device with
``compute_dtype`` and the kwargs, and loads the weights strictly); its
cells' limits under ``portbench/limits/``; and per-layer metrics, where it
needs its own, under ``portbench/metrics/``.
"""

from __future__ import annotations

import dataclasses
import importlib
import re
import types
from pathlib import Path
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .precision import FLOAT32, Precision, net_input

_VGG16 = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
_MONO_ENC = ((32, 7), (64, 5), (128, 3), (256, 3), (512, 3), (512, 3), (512, 3))
_MONO_DEC = (512, 512, 256, 128, 64, 32, 16)  # channels of levels 7 .. 1
FCN_FC = 4096


@dataclasses.dataclass(frozen=True)
class Layer:
    name: str
    cin: int
    cout: int
    k: int
    stride: int = 1
    transposed: bool = False
    init: str = "lecun"  # "lecun" (normal, std 1/sqrt(fan-in)) or "decoder" (std 0.01)

    @property
    def weight_shape(self):
        io = (self.cin, self.cout) if self.transposed else (self.cout, self.cin)
        return io + (self.k, self.k)


LAWS = ("lecun", "normal", "zeros", "ones")


@dataclasses.dataclass(frozen=True)
class Param:
    """One parameter of a ``params`` module: its key in the weights (the
    port's ``state_dict`` key, ``.weight`` or ``.bias`` included), its shape
    and its init law. ``lecun``: a unit normal clamped at +-2, scaled to std
    1 / sqrt(``fan_in``); ``normal``: the same clamped normal scaled to std
    ``std``; ``zeros``; ``ones`` (``harness/weights.make_params``)."""
    name: str
    shape: Tuple[int, ...]
    law: str
    fan_in: int = 0
    std: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))
        if self.law not in LAWS:
            raise ValueError(f"{self.name}: init law {self.law!r} is none of {LAWS}")
        if self.law == "lecun" and self.fan_in < 1:
            raise ValueError(f"{self.name}: the lecun law needs its fan-in")
        if self.law == "normal" and not self.std > 0:
            raise ValueError(f"{self.name}: the normal law needs its std")


def _scaled(c: int, width: float) -> int:
    return max(1, int(c * width))


def fcn_layers(num_classes: int = 3, input_s2d: bool = False, width: float = 1.0,
               fc: int = FCN_FC) -> List[Layer]:
    """``width`` scales the trunk's channels (1 everywhere but the tests'
    tiny networks)."""
    out, cin = [], 12 if input_s2d else 3
    for b, (n, ch) in enumerate(_VGG16, start=1):
        for i in range(1, n + 1):
            out.append(Layer(f"conv{b}_{i}", cin, _scaled(ch, width), 3))
            cin = _scaled(ch, width)
    nc = num_classes
    out += [Layer("fc6", cin, fc, 7), Layer("fc7", fc, fc, 1),
            Layer("score_fc7", fc, nc, 1, init="decoder"),
            Layer("score_pool4", _scaled(512, width), nc, 1, init="decoder"),
            Layer("score_pool3", _scaled(256, width), nc, 1, init="decoder"),
            Layer("upscore2", nc, nc, 4, 2, True, "decoder"),
            Layer("upscore4", nc, nc, 4, 2, True, "decoder"),
            Layer("upscore8", nc, 4 * nc if input_s2d else nc, 16, 8, True, "decoder")]
    return out


def mono_layers(input_s2d: bool = False, width: float = 1.0) -> List[Layer]:
    out, cin, feats = [], 12 if input_s2d else 3, []
    for i, (c, k) in enumerate(_MONO_ENC, start=1):
        c = _scaled(c, width)
        out += [Layer(f"enc{i}a", cin, c, k), Layer(f"enc{i}b", c, c, k, 2)]
        feats.append(c)
        cin = c
    skips = feats[:-1]
    n = len(_MONO_DEC)
    for level in range(n, 0, -1):
        c = _scaled(_MONO_DEC[n - level], width)
        out.append(Layer(f"upconv{level}", cin, c, 3))
        cat = c + (skips[level - 2] if 0 <= level - 2 < len(skips) else 0)
        cat += 2 if level < 4 else 0
        out.append(Layer(f"iconv{level}", cat, c, 3))
        if level <= 4:
            out.append(Layer(f"disp{level}", c, 2, 3))
        cin = c
    if input_s2d:
        c = _scaled(8, width)
        out += [Layer("upconv0", cin, c, 3), Layer("iconv0", c + 2, c, 3), Layer("disp0", c, 2, 3)]
    return out


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), phase-major channels."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    b, h, w, cc = x.shape
    x = x.reshape(b, h, w, 2, 2, cc // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, cc // 4)


class _Net:
    def __init__(self, weights: Dict[str, torch.Tensor], prec: Precision):
        self.w, self.prec = weights, prec

    def _bias(self, name):
        """``name``'s bias in float32, or None where it has none."""
        b = self.w.get(f"{name}.bias")
        return None if b is None else b.float()

    def conv(self, name, x, stride=1, pad=None, groups=1):
        w = self.w[f"{name}.weight"]
        pad = (w.shape[-1] - 1) // 2 if pad is None else pad
        return F.conv2d(net_input(x, self.prec), net_input(w, self.prec), self._bias(name),
                        stride, pad, 1, groups)

    def conv_t(self, name, x, stride, pad):
        w = self.w[f"{name}.weight"]
        return F.conv_transpose2d(net_input(x, self.prec), net_input(w, self.prec),
                                  self._bias(name), stride, pad)

    def linear(self, name, x):
        """``x @ weight.T + bias`` of the (out, in) weight ``name``."""
        return F.linear(net_input(x, self.prec), net_input(self.w[f"{name}.weight"], self.prec),
                        self._bias(name))

    def matmul(self, a, b):
        """A product of two activations (attention's scores and mixing)."""
        return torch.matmul(net_input(a, self.prec), net_input(b, self.prec))


def fcn_logits(weights, images: torch.Tensor, input_s2d: bool = False,
               prec: Precision = FLOAT32) -> torch.Tensor:
    """images (B, H, W, 3) 0..255 -> class logits (B, H, W, C) float32."""
    net = _Net(weights, prec)
    x = images.float()
    if input_s2d:
        x = space_to_depth(x)
    x = x.permute(0, 3, 1, 2)
    pools = []
    for b, (n, _) in enumerate(_VGG16, start=1):
        for i in range(1, n + 1):
            x = F.relu(net.conv(f"conv{b}_{i}", x, pad=1))
        x = F.max_pool2d(x, 2, 2)
        pools.append(x)
    x = F.relu(net.conv("fc6", x, pad=3))
    x = F.relu(net.conv("fc7", x, pad=0))
    x = net.conv_t("upscore2", net.conv("score_fc7", x, pad=0), 2, 1) + net.conv(
        "score_pool4", pools[3], pad=0)
    x = net.conv_t("upscore4", x, 2, 1) + net.conv("score_pool3", pools[2], pad=0)
    x = net.conv_t("upscore8", x, 8, 4).permute(0, 2, 3, 1)
    return depth_to_space(x) if input_s2d else x


def _up2(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def mono_disparity(weights, images01: torch.Tensor, input_s2d: bool = False,
                   prec: Precision = FLOAT32) -> torch.Tensor:
    """images (B, H, W, 3) in [0, 1] -> the finest left disparity (B, H, W)."""
    net = _Net(weights, prec)
    x = images01.float()
    if input_s2d:
        x = space_to_depth(x)
    x = x.permute(0, 3, 1, 2)
    feats = []
    for i in range(1, len(_MONO_ENC) + 1):
        x = F.elu(net.conv(f"enc{i}b", F.elu(net.conv(f"enc{i}a", x)), stride=2))
        feats.append(x)
    skips, x = feats[:-1], feats[-1]
    udisp = disp = None
    for level in range(len(_MONO_DEC), 0, -1):
        x = F.elu(net.conv(f"upconv{level}", _up2(x)))
        cat = [x]
        if 0 <= level - 2 < len(skips):
            cat.append(skips[level - 2])
        if udisp is not None:
            cat.append(udisp)
        x = F.elu(net.conv(f"iconv{level}", torch.cat(cat, 1)))
        if level <= 4:
            disp = 0.3 * torch.sigmoid(net.conv(f"disp{level}", x))
            udisp = _up2(disp) if level > 1 else None
    if input_s2d:
        x = F.elu(net.conv("upconv0", _up2(x)))
        x = F.elu(net.conv("iconv0", torch.cat([x, _up2(disp)], 1)))
        disp = 0.3 * torch.sigmoid(net.conv("disp0", x))
    return disp[:, 0]


def flip_blend(disp: torch.Tensor, disp_of_flipped: torch.Tensor) -> torch.Tensor:
    """Monodepth's test-time post-processing (Godard et al. 2017, sec. 4):
    the disparity of the frame and the mirrored disparity of its mirror,
    each trusted on its own 5% border ramp and averaged in between."""
    h, w = disp.shape[-2:]
    l_disp = disp
    r_disp = disp_of_flipped.flip(-1)
    m_disp = 0.5 * (l_disp + r_disp)
    ramp = torch.arange(w, dtype=torch.float32, device=disp.device)
    ramp = ramp / ramp.new_tensor(float(w - 1))
    l_mask = (1.0 - torch.clamp(20.0 * (ramp - 0.05), 0.0, 1.0)).expand(h, w)
    r_mask = l_mask.flip(-1)
    return r_mask * l_disp + l_mask * r_disp + (1.0 - l_mask - r_mask) * m_disp


def _vgg16_layers(input_s2d: bool, width: float, num_classes: int, fc_channels: int):
    return fcn_layers(num_classes, input_s2d, width, fc_channels)


FORWARD = {"fcn": "logits", "mono": "disparity"}  # kind -> the forward pass's name
_BUILT_IN = {
    ("fcn", "vgg16"): types.SimpleNamespace(layers=_vgg16_layers, logits=fcn_logits),
    ("mono", "vgg"): types.SimpleNamespace(layers=mono_layers, disparity=mono_disparity),
}
_HERE = Path(__file__).resolve().parent
_SHOWN = _HERE.relative_to(_HERE.parent.parent)  # portbench/reference


def encoders(kind: str) -> List[str]:
    """Every encoder of ``kind`` that ``network`` resolves: the built-in one
    and each ``<kind>_<encoder>.py`` here."""
    files = {p.stem[len(kind) + 1:] for p in _HERE.glob(f"{kind}_*.py")}
    return sorted(files | {e for k, e in _BUILT_IN if k == kind})


def lists_params(ref) -> bool:
    """Whether the reference ``ref`` (from ``network``) lists its ``params``
    rather than its ``layers``."""
    return callable(getattr(ref, "params", None))


def forward_arg(ref, slot: Dict):
    """What ``ref``'s forward pass takes after the images: the
    configuration's ``networks.<slot>`` dict for a ``params`` module, its
    ``input_s2d`` for a ``layers`` one."""
    return slot if lists_params(ref) else slot["input_s2d"]


def network(kind: str, encoder: str):
    """The reference of the ``kind`` network with ``encoder``: ``layers`` or
    ``params``, and the forward pass ``FORWARD[kind]``. Raises
    ``LookupError`` naming the file looked for where there is none, and
    naming what a module there lacks."""
    if (kind, encoder) in _BUILT_IN:
        return _BUILT_IN[kind, encoder]
    name = f"{kind}_{encoder}"
    shown = f"{_SHOWN}/{name}.py"
    if kind not in FORWARD or not re.fullmatch(r"[A-Za-z0-9_]+", encoder):
        raise LookupError(f"no {kind!r} network with the encoder {encoder!r}")
    try:
        module = importlib.import_module(f"{__package__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__package__}.{name}":
            raise
        raise LookupError(f"no reference for the {kind} encoder {encoder!r}: "
                          f"{shown} is not there") from None
    missing = [a for a in (FORWARD[kind],) if not callable(getattr(module, a, None))]
    if not (lists_params(module) or callable(getattr(module, "layers", None))):
        missing.insert(0, "layers or params")
    if missing:
        raise LookupError(f"{shown} does not define {', '.join(missing)}")
    return module
