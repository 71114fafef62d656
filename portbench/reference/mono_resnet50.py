"""Monodepth with the ResNet-50 encoder in plain PyTorch, from Godard et al.,
CVPR 2017, and the published code (mrharicot/monodepth,
``monodepth_model.py``: ``build_resnet50``, ``resconv``, ``resblock``,
``maxpool``, ``upconv``, ``get_disp``).

Every convolution pads its input by (k - 1) // 2 on every side, then
convolves VALID; ELU follows every convolution but a block's third and its
shortcut. The encoder:

* ``enc1``: a 7x7/2 convolution (conv1, H/2);
* a 3x3/2 max pool over the map padded by one ZERO on every side (pool1,
  H/4): the published ``maxpool`` pads with ``tf.pad``'s zeros, and ELU
  outputs reach -1, so a -inf padding would change the border;
* four stages of 3, 4, 6 and 3 bottleneck blocks of widths 64, 128, 256
  and 512 (res2 .. res5, H/8 .. H/64). A block is ``elu(c3(elu(c2(elu(c1(x)))))
  + sc(x))``: ``c1`` 1x1 to the width, ``c2`` 3x3, ``c3`` 1x1 to four times
  the width, ``sc`` a 1x1 projection of the block's input to four times the
  width. The last block of a stage strides 2, in ``c2`` and in ``sc``.

The decoder, levels 6 to 1: upsample by pixel repetition and a 3x3
convolution (``upconv``), concatenate the encoder output of the same size
(conv4, conv3, conv2, pool1, conv1 for levels 6 .. 2) and, below level 4,
the upsampled coarser disparity, a 3x3 convolution (``iconv``), and at
levels 4 to 1 the disparities 0.3 * sigmoid(3x3 convolution). The finest
left disparity is the output. With ``input_s2d`` the input is packed 2x2
into channels (``nets.space_to_depth``) and a level-0 step (``upconv0`` /
``iconv0`` / ``disp0``, 8 channels) restores the input resolution.

Departures from the published code:

* every block projects its shortcut. The published ``resconv`` projects
  where ``do_proj = tf.shape(x)[3] != num_layers or stride == 2``, which
  compares a ``tf.shape`` tensor with a number and is always true in TF1,
  and the published checkpoints carry a shortcut in every block;
* the weights follow the benchmark's lecun law (``harness/weights.py``),
  not slim's xavier initialiser.

Every convolution goes through ``nets._Net.conv``, so the control's
float8 operands and ``REORDERED`` reach it; it computes in float32 and
imports nothing of the program or of JAX.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from .nets import Layer, _Net, _scaled, _up2, space_to_depth
from .precision import FLOAT32, Precision

STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))  # res2 .. res5: (width, blocks)
_DEC = (512, 256, 128, 64, 32, 16)  # channels of levels 6 .. 1


def _blocks():
    """(stage, block, stride) of every bottleneck block in order."""
    for stage, (_, n) in enumerate(STAGES, start=2):
        for i in range(n):
            yield stage, i, 2 if i == n - 1 else 1


def layers(input_s2d: bool = False, width: float = 1.0) -> List[Layer]:
    """The layers, named as the port's parameters; ``width`` scales every
    channel count (1 everywhere but the tests' tiny networks)."""
    c = _scaled(64, width)
    out = [Layer("enc1", 12 if input_s2d else 3, c, 7, 2)]
    cin, skips = c, [c, c]  # conv1, pool1
    for stage, i, stride in _blocks():
        mid = _scaled(STAGES[stage - 2][0], width)
        cout = _scaled(4 * STAGES[stage - 2][0], width)
        name = f"res{stage}_{i}"
        out += [Layer(f"{name}_c1", cin, mid, 1), Layer(f"{name}_c2", mid, mid, 3, stride),
                Layer(f"{name}_c3", mid, cout, 1), Layer(f"{name}_sc", cin, cout, 1, stride)]
        cin = cout
        if stride == 2:
            skips.append(cout)  # res2 .. res4 (res5 is the bottom)
    skips = skips[:5]
    n = len(_DEC)
    for level in range(n, 0, -1):
        c = _scaled(_DEC[n - level], width)
        out.append(Layer(f"upconv{level}", cin, c, 3))
        cat = c + (skips[level - 2] if level >= 2 else 0) + (2 if level < 4 else 0)
        out.append(Layer(f"iconv{level}", cat, c, 3))
        if level <= 4:
            out.append(Layer(f"disp{level}", c, 2, 3))
        cin = c
    if input_s2d:
        c = _scaled(8, width)
        out += [Layer("upconv0", cin, c, 3), Layer("iconv0", c + 2, c, 3), Layer("disp0", c, 2, 3)]
    return out


def disparity(weights, images01: torch.Tensor, input_s2d: bool = False,
              prec: Precision = FLOAT32) -> torch.Tensor:
    """images (B, H, W, 3) in [0, 1] -> the finest left disparity (B, H, W)
    float32."""
    net = _Net(weights, prec)
    x = images01.float()
    if input_s2d:
        x = space_to_depth(x)
    conv1 = F.elu(net.conv("enc1", x.permute(0, 3, 1, 2), stride=2))
    x = F.max_pool2d(F.pad(conv1, (1, 1, 1, 1)), 3, 2)
    skips = [conv1, x]  # skip1, skip2
    for stage, i, stride in _blocks():
        name = f"res{stage}_{i}"
        y = F.elu(net.conv(f"{name}_c1", x))
        y = F.elu(net.conv(f"{name}_c2", y, stride=stride))
        x = F.elu(net.conv(f"{name}_c3", y) + net.conv(f"{name}_sc", x, stride=stride))
        if stride == 2:
            skips.append(x)  # skip3 .. skip5, then the bottom
    skips = skips[:5]
    udisp = disp = None
    for level in range(len(_DEC), 0, -1):
        x = F.elu(net.conv(f"upconv{level}", _up2(x)))
        cat = [x] + ([skips[level - 2]] if level >= 2 else [])
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
