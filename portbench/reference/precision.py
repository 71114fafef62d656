"""The reference's arithmetic: float32, or one step below it for the control.

``Precision("float32")`` is the reference: full float32 convolutions and
matrix products (TF32 off). The control computes the same program one step
below what each part of the configuration states:

* the networks, stated in bfloat16: float8 (e4m3, one scale a tensor) for
  every convolution's and every matrix product's input and weight (a
  Linear layer's, attention's two products: ``nets._Net``), accumulated
  in float32;
* the geometry, stated in float32: TF32 for every matrix or inner product
  (both operands rounded to 10 mantissa bits, accumulated in float32).

Both roundings are written out here rather than left to a library switch,
so the control reads the same on the card and on the CPU.

``REORDERED`` is the reference in full float32 with its inner products and
sums in the libraries' order (matrix products, ``sum``) rather than the
program's kernels' order: a sound program that sums in another order. Its
readings against the reference are among the lower readings of each limit,
so that a limit does not hold the program to one order of summation.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

_E4M3_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Precision:
    networks: str = "float32"  # "float32" | "float8"
    matmul: str = "float32"  # "float32" | "tf32"
    order: str = "kernel"  # "kernel" (the program's kernels' order) | "library"


FLOAT32 = Precision()
CONTROL = Precision(networks="float8", matmul="tf32")
REORDERED = Precision(order="library")


def to_float8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to the format's largest value, back in float32."""
    amax = x.abs().amax()
    if float(amax) == 0.0:
        return x
    scale = amax / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest-even at 10 mantissa bits; inf and
    nan left as they are."""
    x = x.float().contiguous()
    bits = x.view(torch.int32)
    rounded = (bits + (((bits >> 13) & 1) + 0xFFF)) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)


def product_operand(x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """An operand of a matrix or inner product as ``prec`` computes it."""
    return to_tf32(x) if prec.matmul == "tf32" else x.float()


def matmul(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    return torch.matmul(product_operand(a, prec), product_operand(b, prec))


def dot(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """The inner product of the last axis: products then one sum, or in the
    ``library`` order a matrix product."""
    a, b = product_operand(a, prec), product_operand(b, prec)
    if prec.order == "library":
        return torch.matmul(a[..., None, :], b[..., :, None])[..., 0, 0]
    return (a * b).sum(-1)


def net_input(x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """An operand of a network's convolution or matrix product as ``prec``
    computes it (float32 storage)."""
    x = x.float()
    return to_float8(x) if prec.networks == "float8" else x


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuDNN and cuBLAS while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
