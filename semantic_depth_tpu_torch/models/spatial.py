"""The networks' row-sharded layers: the sp mesh axis's halo exchange, in
one place.

The JAX package shards image rows over 'sp' from an input sharding, and
GSPMD inserts a halo exchange before every convolution that reads
neighbouring rows. Here ``FCN8s`` and ``Monodepth`` route each such layer
through the functions below, with ``rows`` the forward's
``parallel.spatial.RowShard`` or None. With None every function is the
layer's own call, so the single-device path runs exactly the code it ran
before. ``rows`` decides the layout of each level and moves the rows
(``split``, ``rows_of``, ``is_split``, ``whole``, ``settle``, ``halo``); this
module only computes which rows a layer reads and runs it on them, so the
networks import nothing of the parallel layer.

Memory layout. The networks permute NHWC frames to NCHW, so their
activations are channels-last in memory, and cuDNN picks its kernels by
layout. A block that went through a collective or a concatenation is put
back in the layout of the tensor it stands for (``like``). With that, on
an H100 in float32, each sharded convolution gives the unsharded one's
bits for its rows (every convolution of both networks at 256x512, the
4x4/2 transposed convolutions of FCN-8s aside, which differ in the last
bits), and sp=2's disparity equals the single-device one bit for bit
(``chip_smoke.py`` phase 11).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` in the memory layout of ``x`` (channels-last or contiguous)."""
    if x.dim() == 4 and x.shape[1] > 1 and x.stride(1) == 1:
        return y.contiguous(memory_format=torch.channels_last)
    return y.contiguous()


def conv(layer: torch.nn.Conv2d, x: torch.Tensor, rows) -> torch.Tensor:
    """``layer(x)`` on NCHW ``x``, row-sharded under ``rows``."""
    if rows is None:
        return layer(x)
    k, s, p = layer.kernel_size[0], layer.stride[0], layer.padding[0]
    g = rows.rows_of(x)
    g_out = (g + 2 * p - k) // s + 1
    if not rows.split(g_out):
        y = layer(rows.whole(x) if rows.is_split(x) else x)
        return rows.settle(y)
    # a split output level of stride s reads a split input level of s times
    # its rows (every conv of these networks on an even level, and split(g / s)
    # implies split(g) for s in {1, 2}): each block reads the rows above and
    # below its own
    if not (rows.is_split(x) and g == g_out * s):
        raise ValueError(f"a {k}x{k}/{s} conv with padding {p} maps {g} rows to {g_out}: "
                         "its blocks do not read their own input block and a halo")
    ext = rows.halo(x, p, max(0, k - s - p))
    return F.conv2d(ext, layer.weight, layer.bias, layer.stride, (0, layer.padding[1]),
                    layer.dilation, layer.groups)


def conv_transpose(layer: torch.nn.ConvTranspose2d, x: torch.Tensor, rows) -> torch.Tensor:
    """``layer(x)`` on NCHW ``x`` (a transposed convolution), row-sharded
    under ``rows``: a block of output rows reads ``ceil((k - 1 - p) / s)``
    input rows above its own and ``floor((s - 1 + p) / s)`` below."""
    if rows is None or not rows.is_split(x):
        return layer(x) if rows is None else rows.settle(layer(x))
    k, s, p = layer.kernel_size[0], layer.stride[0], layer.padding[0]
    top, bottom = -(-(k - 1 - p) // s), (s - 1 + p) // s
    n = x.shape[-2]
    y = F.conv_transpose2d(rows.halo(x, top, bottom), layer.weight, layer.bias, layer.stride,
                           (0, layer.padding[1]), layer.output_padding, layer.groups,
                           layer.dilation)
    return rows.settle(y[..., top * s + p:top * s + p + n * s, :])


def max_pool2(x: torch.Tensor, rows) -> torch.Tensor:
    """2x2/2 max pool: row-local on a split level (its blocks are even)."""
    return F.max_pool2d(x, 2, 2) if rows is None else rows.settle(F.max_pool2d(x, 2, 2))


def max_pool3_zero_padded(x: torch.Tensor, rows) -> torch.Tensor:
    """The resnet50 stem's 3x3/2 max pool over a ZERO-padded map."""
    if rows is None or not rows.is_split(x):
        y = F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)
        return y if rows is None else rows.settle(y)
    ext = rows.halo(x, 1, 0)  # zero rows beyond the frame
    return rows.settle(F.max_pool2d(F.pad(ext, (1, 1, 0, 0)), 3, 2))


def upsample_nn(x: torch.Tensor, rows) -> torch.Tensor:
    """Nearest-neighbour x2 (pixel repeat): row-local."""
    y = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return y if rows is None else rows.settle(y)
