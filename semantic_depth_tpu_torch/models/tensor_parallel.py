"""FCN-8s's tensor-parallel layers: fc6 and fc7 split over the tp mesh
axis, in one place.

The JAX package splits fc6's output channels and fc7's input channels over
'tp' with sharding annotations, and XLA sums fc7's partial outputs. Here
``FCN8s.forward`` routes fc6, fc7 and their dropout through the functions
below, with ``tp`` the forward's ``parallel.train_step.TensorShard`` or
None. With None every function is the layer's own call (through
``spatial``'s row sharding when the forward has ``rows``), so the
single-device path runs exactly the code it ran before. ``tp`` holds the
group and moves the data (``copy_in``, ``reduce_out``); this module only
says which layer holds which block, so the network imports nothing of the
parallel layer.

The pairing is Megatron's: fc6 holds a block of output channels (and of
its bias), so its ReLU and dropout stay local; fc7 holds the same block of
input channels, and the ranks' partial outputs are summed. fc6's input is
the whole activation on every rank, and its gradient is the sum of the
ranks' partial gradients (``copy_in``); without that sum the layers below
fc6 would get a different gradient on each rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import spatial


def column(layer: torch.nn.Conv2d, x: torch.Tensor, tp, rows=None) -> torch.Tensor:
    """fc6: ``layer`` holds this rank's block of output channels."""
    return spatial.conv(layer, x, rows) if tp is None else layer(tp.copy_in(x))


def row(layer: torch.nn.Conv2d, x: torch.Tensor, tp, rows=None) -> torch.Tensor:
    """fc7: ``layer`` holds this rank's block of input channels; the partial
    outputs are summed over tp, and the bias, which every rank holds whole,
    is added once, after the sum."""
    if tp is None:
        return spatial.conv(layer, x, rows)
    y = F.conv2d(x, layer.weight, None, layer.stride, layer.padding, layer.dilation,
                 layer.groups)
    return tp.reduce_out(y) + layer.bias.view(1, -1, 1, 1)


def keep_mask(x: torch.Tensor, keep: float, generator, tp, split: bool) -> torch.Tensor:
    """Dropout's keep mask for NCHW ``x``, the single-device one: drawn at
    the single-device shape (the whole batch; all channels, where ``split``
    says this rank holds a block of them) from the same generator, then cut
    to this rank's batch rows and channel block."""
    if tp is None:
        return torch.rand(x.shape, generator=generator, device=x.device) < keep
    b, c, h, w = x.shape
    full = (tp.batch, c * tp.size if split else c, h, w)
    mask = (torch.rand(full, generator=generator, device=x.device) < keep)[tp.rows]
    return mask[:, tp.channels(full[1])] if split else mask
